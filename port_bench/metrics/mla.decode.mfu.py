"""Model-FLOP share of an MLA model's replayed B 1 decode step: the FLOPs
of the absorbed step (`mla_counts.decode_flops`) over the step's time
between CUDA events times the card's bf16 peak, summed over the
configuration's MLA models, in %."""
from pbench import mla_counts as mc


def read(ctx):
    steps = mc.steps_of(ctx)
    if not steps:
        return None
    flops = sum(mc.decode_flops(ctx.cfgs[r.model_id], r.mean_length) for r in steps)
    return 100.0 * flops / (sum(r.decode_step_s for r in steps) * mc.PEAK_FLOPS["bfloat16"])
