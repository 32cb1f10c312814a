"""`tpot_p90_ms` in a cold-start cell, under a bound of its own: the same reading."""
from pbench.cell import reader

read = reader("end_to_end", "tpot_p90_ms")
