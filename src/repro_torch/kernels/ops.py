"""Public kernel entry points (port of `repro/kernels/ops.py`).

Each dispatches on the device of its tensors: CPU tensors run the plain
PyTorch version, CUDA tensors the hand-written Hopper kernel (or raise).
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.moe_experts import moe_experts  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.ref import (flash_attention_ref, moe_experts_ref,  # noqa: F401
                                     paged_attention_ref)

# every kernel wrapper of the port (each carries a `.launches` counter)
KERNELS = {"paged_attention": paged_attention, "flash_attention": flash_attention,
           "moe_experts": moe_experts}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_of(fn: Callable[[], Any]) -> tuple[Any, dict[str, int]]:
    """Run `fn()` and return its result with the launches its wrappers
    counted, leaving the counters as they were.  A CUDA graph capture runs
    the wrappers without launching anything: its launches happen at each
    replay, which adds them back with `count_launches`."""
    before = launch_counts()
    try:
        out = fn()
    finally:
        made = {name: n - before[name] for name, n in launch_counts().items()}
        for name, f in KERNELS.items():
            f.launches = before[name]
    return out, {name: n for name, n in made.items() if n}


def count_launches(made: dict[str, int]):
    """Add launches made outside the wrappers' Python (a graph's replay)."""
    for name, n in made.items():
        KERNELS[name].launches += n
