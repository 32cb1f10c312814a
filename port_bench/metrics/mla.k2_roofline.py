"""K2's share of its roofline at split widths in an MLA model's B 1 prefill
at the cell's prompt: the least time of its calls (`mla_counts.k2_bound`,
one call a layer) over K2's device time in one profiled prefill
(`torch.profiler`), summed over the configuration's MLA models, in %."""
from pbench import mla_counts as mc


def read(ctx):
    steps = [r for r in mc.steps_of(ctx) if r.k2_s > 0]
    if not steps:
        return None
    least = sum(ctx.cfgs[r.model_id]["num_layers"] * mc.k2_bound(ctx.cfgs[r.model_id], r.prompt)
                for r in steps)
    return 100.0 * least / sum(r.k2_s for r in steps)
