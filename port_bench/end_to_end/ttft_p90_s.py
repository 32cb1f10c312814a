"""90th percentile over the window's requests of the Gateway's time to
first token: queue + init + load + profile + prefill (`TTFTRecord.ttft`)."""
from pbench.stats import percentile


def read(ctx):
    ttfts = [s.record.ttft for s in ctx.served]
    return percentile(ttfts, 0.90) if ttfts else None
