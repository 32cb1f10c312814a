"""K1's share of its roofline in the decode step: the least time of its
calls (`counts.k1_bytes` at 3.35 TB/s, one call a layer) over K1's device
time in the profiled steps (`torch.profiler`), summed over the
configuration's models, in %."""
from pbench import counts

TABLE_BLOCKS = 64  # the block table's width: Engine.start_instance's max_blocks_per_seq


def read(ctx):
    steps = [r for r in ctx.steps if r.k1_step_s > 0]
    if not steps:
        return None
    # the profiled steps come before the timed ones: `steps` fewer keys
    least = sum(ctx.cfgs[r.model_id]["num_layers"]
                * counts.k1_bytes(ctx.cfgs[r.model_id], r.mean_length - r.steps, TABLE_BLOCKS)
                / counts.HBM_BYTES_PER_S for r in steps)
    return 100.0 * least / sum(r.k1_step_s for r in steps)
