"""Share of the window's time to first token spent in the Gateway's queue:
sum of `queue_s` over sum of `ttft`, in %."""


def read(ctx):
    ttft = sum(s.record.ttft for s in ctx.served)
    return 100.0 * sum(s.record.queue_s for s in ctx.served) / ttft if ttft > 0 else None
