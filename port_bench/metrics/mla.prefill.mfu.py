"""Model-FLOP share of an MLA model's B 1 prefill at the cell's prompt: its
model FLOPs (`mla_counts.prefill_flops`: the published equations, the
active experts only) over its wall between CUDA events times the card's
bf16 peak, summed over the configuration's MLA models, in %."""
from pbench import mla_counts as mc


def read(ctx):
    steps = mc.steps_of(ctx)
    if not steps:
        return None
    flops = sum(mc.prefill_flops(ctx.cfgs[r.model_id], r.prompt) for r in steps)
    return 100.0 * flops / (sum(r.prefill_s for r in steps) * mc.PEAK_FLOPS["bfloat16"])
