"""Public kernel entry points (port of `repro/kernels/ops.py`).

Each dispatches on the device of its tensors: CPU tensors run the plain
PyTorch version, CUDA tensors the hand-written Hopper kernel (or raise).
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.kernels.add_rms_norm import add_rms_norm  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.moe_experts import moe_experts  # noqa: F401
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: F401
                                                paged_latent_attention)
from repro_torch.kernels.ref import (add_rms_norm_ref, flash_attention_ref,  # noqa: F401
                                     moe_experts_ref, paged_attention_ref,
                                     paged_latent_attention_ref, rope_kv_write_ref)
from repro_torch.kernels.rope_kv_write import rope_kv_write  # noqa: F401

# every kernel wrapper of the port (each carries a `.launches` counter)
KERNELS = {"paged_attention": paged_attention, "flash_attention": flash_attention,
           "moe_experts": moe_experts, "rope_kv_write": rope_kv_write,
           "add_rms_norm": add_rms_norm}
# calls of a kernel in one of its modes, counted again beside its `.launches`:
# name -> (the wrapper, the attribute); K1's latent mode (MLA decode) and K2
# at split q/k and v widths (MLA prefill)
MODES = {"paged_attention.latent": (paged_attention, "latent_launches"),
         "flash_attention.split": (flash_attention, "split_launches")}


def _counters() -> dict[str, tuple]:
    return {**{n: (fn, "launches") for n, fn in KERNELS.items()}, **MODES}


def reset_launch_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def mode_counts() -> dict[str, int]:
    """The calls counted in each of `MODES`."""
    return {name: getattr(fn, attr) for name, (fn, attr) in MODES.items()}


def launches_of(fn: Callable[[], Any]) -> tuple[Any, dict[str, int]]:
    """Run `fn()` and return its result with the launches its wrappers
    counted, leaving the counters as they were.  A CUDA graph capture runs
    the wrappers without launching anything: its launches happen at each
    replay, which adds them back with `count_launches`."""
    counters = _counters()
    before = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    try:
        out = fn()
    finally:
        made = {name: getattr(f, attr) - before[name] for name, (f, attr) in counters.items()}
        for name, (f, attr) in counters.items():
            setattr(f, attr, before[name])
    return out, {name: n for name, n in made.items() if n}


def count_launches(made: dict[str, int]):
    """Add launches made outside the wrappers' Python (a graph's replay)."""
    counters = _counters()
    for name, n in made.items():
        f, attr = counters[name]
        setattr(f, attr, getattr(f, attr) + n)
