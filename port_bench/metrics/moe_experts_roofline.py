"""The routed experts' share of their roofline in the decode step: the
least time of one MoE layer's routed experts at B 1
(`counts.moe_experts_bytes` at 3.35 TB/s, one call a MoE layer) over the
device time of the experts' two kernels in the profiled replays
(`torch.profiler`, the prefill before them left out), summed over the
configuration's models that ran them, in %.  Where no step ran them the
kernels are off the path and the metric is silent."""
from pbench import counts


def read(ctx):
    steps = [r for r in ctx.steps if r.experts_step_s > 0]
    if not steps:
        return None
    least = sum(counts.moe_layers(ctx.cfgs[r.model_id])
                * counts.moe_experts_bytes(ctx.cfgs[r.model_id]) / counts.HBM_BYTES_PER_S
                for r in steps)
    return 100.0 * least / sum(r.experts_step_s for r in steps)
