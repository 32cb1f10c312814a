"""`decode.fresh_key_share` in a cold-start cell, where it moves `tpot_p90_ms.cold`: the same reading."""
from pbench.cell import reader

read = reader("metrics", "decode.fresh_key_share")
