"""Model-FLOP share of a replayed B 1 decode step: the FLOPs of the active
weights and the attention a token needs (`counts.decode_flops`) over the
step's time between CUDA events times the card's bf16 peak, summed over the
configuration's models, in %."""
from pbench import counts


def read(ctx):
    if not ctx.steps:
        return None
    flops = sum(counts.decode_flops(ctx.cfgs[r.model_id], r.mean_length) for r in ctx.steps)
    secs = sum(r.decode_step_s for r in ctx.steps)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS["bfloat16"])
