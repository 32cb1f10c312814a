"""Share of the profiled slice (requests of the cell's trace served right
after the window) in which no kernel, copy or fill ran on the device, in %."""


def read(ctx):
    s = ctx.slice
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
