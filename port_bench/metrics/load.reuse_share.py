"""Share of the bytes the window's loads asked for that the pool already
held on the device (`DataLoadStats.bytes_device_hit` over the model's
bytes), in %."""


def read(ctx):
    total = sum(ctx.model_bytes[s.arrival.model_id] for s in ctx.served)
    hit = sum(s.load[1].bytes_device_hit for s in ctx.served)
    return 100.0 * hit / total if total else None
