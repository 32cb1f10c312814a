"""Share of the window's decode steps that replayed a captured graph:
replays over replays and eager steps (`StepGraphs` counters before and
after the window), in %.  Nothing to read on an engine without graphs."""


def read(ctx):
    (e0, _, r0), (e1, _, r1) = ctx.window.graphs_before, ctx.window.graphs_after
    steps = (r1 - r0) + (e1 - e0)
    return 100.0 * (r1 - r0) / steps if steps else None
