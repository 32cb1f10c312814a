"""`prefill.host_share` in a cold-start cell, where it moves `cold_start_p90_s`: the same reading."""
from pbench.cell import reader

read = reader("metrics", "prefill.host_share")
