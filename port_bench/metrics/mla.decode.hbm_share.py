"""Memory-rate share of an MLA model's replayed B 1 decode step: the bytes
the absorbed step needs (`mla_counts.decode_bytes`: every weight it uses
once, k routed experts and the shared ones, the latent rows) at 3.35 TB/s
over the step's time between CUDA events, summed over the configuration's
MLA models, in %."""
from pbench import mla_counts as mc


def read(ctx):
    steps = mc.steps_of(ctx)
    if not steps:
        return None
    nbytes = sum(mc.decode_bytes(ctx.cfgs[r.model_id], r.mean_length) for r in steps)
    return 100.0 * nbytes / mc.HBM_BYTES_PER_S / sum(r.decode_step_s for r in steps)
