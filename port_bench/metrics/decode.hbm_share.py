"""Memory-rate share of a replayed B 1 decode step: the bytes the step
needs (`counts.decode_bytes`: every weight it uses once, a MoE layer's
routed experts only, and the KV) at 3.35 TB/s over the step's time between
CUDA events, summed over the configuration's models, in %."""
from pbench import counts


def read(ctx):
    if not ctx.steps:
        return None
    nbytes = sum(counts.decode_bytes(ctx.cfgs[r.model_id], r.mean_length) for r in ctx.steps)
    secs = sum(r.decode_step_s for r in ctx.steps)
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / secs
