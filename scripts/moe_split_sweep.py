"""The routed experts (`kernels/moe_experts.py`) at the served decode shapes
with every pair of splits (1, 2, 4, 8 for the gate-up and the down kernel)
in place of `split_plan`'s: the time of one call, over several layers'
weights in turn so that every read comes from device memory as in a decode
step, and its share of the bound, beside the plan's own pair.  Each output
is held against the plain version first.  The evidence for `split_plan`'s
rule (two blocks a SM).  Needs one CUDA card:

    python3 scripts/moe_split_sweep.py
"""
import importlib
import itertools
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# (label, T, k, E, D, F, layers): bf16, the decode steps of qwen3-moe-30b-a3b
# (B 1 and B 4) and mixtral-8x7b (B 1); `layers` copies of the weights,
# more bytes than the 50 MB L2
SHAPES = [("qwen3-moe-30b-a3b B1", 1, 8, 128, 2048, 768, 8),
          ("qwen3-moe-30b-a3b B4", 4, 8, 128, 2048, 768, 4),
          ("mixtral-8x7b B1", 1, 2, 8, 4096, 14336, 2)]
SPLITS = (1, 2, 4, 8)


def main() -> int:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_experts_ref

    me = importlib.import_module("repro_torch.kernels.moe_experts")
    cs.setup()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, T, k, E, D, F, layers in SHAPES:
        x = torch.randn((T, D), generator=gen, device=dev).bfloat16()
        ids = torch.stack([torch.randperm(E, generator=gen, device=dev)[:k] for _ in range(T)])
        w = torch.rand((T, k), generator=gen, device=dev)
        w = w / w.sum(-1, keepdim=True)
        keep = torch.ones((T, k), dtype=torch.bool, device=dev)
        weights = [tuple((torch.randn(s, generator=gen, device=dev) * s[1] ** -0.5).bfloat16()
                         for s in ((E, D, F), (E, D, F), (E, F, D))) for _ in range(layers)]
        bound_ms, _ = cs._bound(T * k * 3 * D * F * 2, T * k * 6 * D * F, "bfloat16")
        plan = me.plans(T, k, D, F, me.tile_columns(torch.bfloat16), sms)
        ref = moe_experts_ref(x, ids, w, keep, *weights[0])
        times = {}
        for up, down in itertools.product(SPLITS, SPLITS):
            if up * me.ROWS > D or down * me.ROWS > k * F:
                continue
            with mock.patch.object(me, "plans", lambda *a, s=(up, down): s):
                cs._check("moe_experts", ops.moe_experts(x, ids, w, keep, *weights[0]), ref,
                          "bfloat16", f"{label} splits {up}/{down}")
                cycle = itertools.cycle(weights)
                times[up, down] = cs.cuda_time_ms(
                    lambda: ops.moe_experts(x, ids, w, keep, *next(cycle)), iters=6 * layers)
        best = min(times.values())
        for (up, down), ms in times.items():
            mark = " <- split_plan" if (up, down) == plan else ""
            cs.log(f"[sweep] {label} splits {up}/{down}: {ms:.4f} ms, {bound_ms / ms:.3f} of the "
                   f"bound, {ms / best:.3f}x the fastest{mark}")
        del weights
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
