"""Model-FLOP share of one B 1 prefill at the cell's prompt: its model
FLOPs (`counts.prefill_flops`) over its wall between CUDA events times the
card's bf16 peak, summed over the configuration's models, in %."""
from pbench import counts


def read(ctx):
    if not ctx.steps:
        return None
    flops = sum(counts.prefill_flops(ctx.cfgs[r.model_id], r.prompt) for r in ctx.steps)
    secs = sum(r.prefill_s for r in ctx.steps)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS["bfloat16"])
