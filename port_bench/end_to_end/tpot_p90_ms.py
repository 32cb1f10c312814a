"""90th percentile over the window's requests of the time per decoded
token: the Gateway's decode wall over its decode steps (a fresh key's eager
step and capture included)."""
from pbench.stats import percentile


def read(ctx):
    steps = ctx.traffic["decode_steps"]
    tpot = [s.record.decode_s / steps * 1e3 for s in ctx.served]
    return percentile(tpot, 0.90) if tpot else None
