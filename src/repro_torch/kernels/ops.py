"""Public kernel entry points (port of `repro/kernels/ops.py`).

Each dispatches on the device of its tensors: CPU tensors run the plain
PyTorch version, CUDA tensors the hand-written Hopper kernel (or raise).
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref  # noqa: F401

# every kernel wrapper of the port (each carries a `.launches` counter)
KERNELS = {"paged_attention": paged_attention, "flash_attention": flash_attention}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
