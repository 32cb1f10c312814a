"""K1's latent mode's share of its roofline in an MLA model's decode step:
the least time of its calls (`mla_counts.k1_bytes` at 3.35 TB/s, one call a
layer, over the rows the profiled steps attend to) over K1's device time
in the profiled steps (its split and merge kernels, `torch.profiler`),
summed over the configuration's MLA models, in %.  Silent where no such
model ran K1."""
from pbench import mla_counts as mc


def read(ctx):
    steps = [r for r in mc.steps_of(ctx) if r.k1_step_s > 0]
    if not steps:
        return None
    least = 0.0
    for r in steps:
        cfg = ctx.cfgs[r.model_id]
        length = r.mean_length - r.steps  # the profiled steps come before the timed ones
        width = mc.table_width(r.prompt + 2 * r.steps + 1)
        least += cfg["num_layers"] * mc.k1_bytes(cfg, length, width) / mc.HBM_BYTES_PER_S
    return 100.0 * least / sum(r.k1_step_s for r in steps)
