"""90th percentile over the window's cold starts (`TTFTRecord.cold`) of the
start itself: init + load + profile + prefill, the time to a first token
that a tenant waits beyond any queue."""
from pbench.stats import percentile


def read(ctx):
    starts = [s.record.ttft - s.record.queue_s for s in ctx.served if s.record.cold]
    return percentile(starts, 0.90) if starts else None
