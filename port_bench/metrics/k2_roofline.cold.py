"""`k2_roofline` in a cold-start cell, where it moves `tokens_per_s.cold`: the same reading."""
from pbench.cell import reader

read = reader("metrics", "k2_roofline")
