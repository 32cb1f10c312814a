"""`tokens_per_s` in a cold-start cell, under a bound of its own: the same reading."""
from pbench.cell import reader

read = reader("end_to_end", "tokens_per_s")
