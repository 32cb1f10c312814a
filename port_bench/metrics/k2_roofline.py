"""K2's share of its roofline in a B 1 prefill at the cell's prompt: the
least time of its calls (`counts.k2_bound`, one call a layer) over K2's
device time in one profiled prefill (`torch.profiler`), summed over the
configuration's models, in %."""
from pbench import counts


def read(ctx):
    steps = [r for r in ctx.steps if r.k2_s > 0]
    if not steps:
        return None
    least = sum(ctx.cfgs[r.model_id]["num_layers"] * counts.k2_bound(ctx.cfgs[r.model_id], r.prompt)
                for r in steps)
    return 100.0 * least / sum(r.k2_s for r in steps)
