"""K1, the port's paged decode kernel, at chip_smoke.py's labelled decode
shapes with splits of 16 to 256 tokens in place of `split_plan`'s: the live
blocks and the kernel's time at each split size, beside the plan's own
split.  Each output is held against the plain version first.  The evidence
for `BLOCKS_PER_SM` and `MAX_SPLITS` in `kernels/paged_attention.py`.
Needs one CUDA card:

    python3 scripts/k1_split_sweep.py
"""
import importlib
import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# (label, B, H, K, hd, T, N, lengths), bf16: chip_smoke.check_kernels' timed K1 rows
SHAPES = [
    ("main", 4, 32, 8, 64, 16, 64, (545, 417, 233, 97)),
    ("long", 1, 32, 8, 64, 16, 256, (4000,)),
    ("deepseek-7b", 1, 32, 32, 128, 16, 64, (cs.SERVERLESS_PROMPT + cs.SERVERLESS_GEN,)),
    ("qwen3-moe-30b-a3b", 1, 32, 4, 128, 16, 64, (cs.FAMILY_PROMPT + cs.SERVERLESS_GEN,)),
    ("qwen2-vl-7b", 1, 28, 4, 128, 16, 64, (cs.FAMILY_PROMPT + cs.SERVERLESS_GEN,)),
    ("yi-9b", 1, 32, 4, 128, 16, 64, (cs.SERVERLESS_PROMPT + cs.SERVERLESS_GEN,)),
    ("codeqwen1.5-7b", 1, 32, 32, 128, 16, 64, (cs.SERVERLESS_PROMPT + cs.SERVERLESS_GEN,)),
]
SPLIT_TOKENS = (16, 32, 64, 128, 256)


def main() -> int:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import paged_attention_ref

    # the module, not the function of that name that `repro_torch.kernels` exports
    pa = importlib.import_module("repro_torch.kernels.paged_attention")

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    for label, B, H, K, hd, T, N, lengths in SHAPES:
        args = cs._paged_inputs(gen, torch.bfloat16, B, H, K, hd, T, N, lengths, dev)
        ref = paged_attention_ref(*args)
        blocks = K * pa.row_groups(H // K)
        own, _ = pa.split_plan(B, blocks, N, T, sms)
        cells = []
        for st in sorted({T * max(1, n // T) for n in SPLIT_TOKENS}):
            fixed = (lambda B, K, N, T, sms, st=st: (st, -(-N * T // st)))
            with mock.patch.object(pa, "split_plan", fixed):
                cs._check("paged_attention", ops.paged_attention(*args), ref, "bfloat16",
                          f"{label} splits of {st} tokens")
                ms = cs.cuda_time_ms(lambda: ops.paged_attention(*args))
            live = sum(math.ceil(n / st) for n in lengths) * blocks
            cells.append(f"{st}: {live} live blocks, {ms:.4f} ms")
        print(f"[plan] paged_attention {label} by split tokens (the plan's {own}): "
              + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
