"""Routed SwiGLU experts of a MoE layer: wrapper of the CUDA kernels in
`csrc/moe_experts.cu`, which replace no TPU kernel (its source note says
why they exist, what bounds them and how they are built).

Layout:
  x       (T, D)          the layer's normed tokens
  ids     (T, k) int64    expert of each (token, choice) pair (`layers.route`)
  w       (T, k) float32  the pair's routing weight
  keep    T * k bool      the pair kept a slot of its expert (`layers._slots`)
  wg, wu  (E, D, F)       every expert's gate and up projections, as pooled
  wd      (E, F, D)       every expert's down projection
Returns y (T, D): for each token, the sum over its kept pairs in choice
order of w * SwiGLU_e(x_t), which is what the slot dispatch computes, read
from the routed experts only.

A CPU tensor runs the plain version (`ref.moe_experts_ref`); a CUDA tensor
launches the kernels on the current stream, or raises (so does a call that
autograd would record: the kernels have no backward).  The wrapper checks
devices, dtypes, shapes and contiguity, never values: it reads nothing back
from the device, so a decode step stays free of host syncs and captures.
One call is two launches (gate and up, then down and combine); their grids
come from `split_plan`, that is from the static shapes and the card's SM
count.  `moe_experts.launches` counts calls, one a MoE layer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (DTYPE_CODES, _sm_count, check_cuda_inputs,
                                                 check_no_autograd, is_concrete_cuda)
from repro_torch.kernels.ref import moe_experts_ref

ROW_BYTES = 128  # a block's columns: 128 bytes of a weight row (8 lanes x 16 bytes)
ROWS = 32  # rows of a pass; divides F
MAX_SPLITS = 8  # a portable thread-block cluster


def tile_columns(dtype: torch.dtype) -> int:
    """Columns of a block's tile: 64 in bfloat16, 32 in float32."""
    return ROW_BYTES // dtype.itemsize


def split_plan(blocks: int, passes: int, sms: int) -> int:
    """Splits of each tile's rows (one cluster of blocks): the least power
    of two up to MAX_SPLITS that gives each of `sms` SMs two blocks when the
    grid has `blocks` tiles, and at most one split a pass of ROWS rows of
    the `passes` a tile has.  Two a SM came out within 1 % of the fastest
    pair of splits at every served shape on an H100 (`scripts/moe_split_sweep.py`)."""
    splits = 1
    while blocks * splits < 2 * sms and 2 * splits <= min(MAX_SPLITS, passes):
        splits *= 2
    return splits


def plans(T: int, k: int, D: int, F: int, C: int, sms: int) -> tuple[int, int]:
    """(splits of the gate-up kernel, splits of the down kernel)."""
    return (split_plan(F // C * T * k, -(-D // ROWS), sms),
            split_plan(D // C * T, k * F // ROWS, sms))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("moe_experts").moe_experts_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, ids, w, keep, wg, wu, wd):
    """Check the operands and launch both kernels on the current stream."""
    T, D = x.shape
    k = ids.shape[1]
    F = wg.shape[2]
    wt = (x.dtype,)
    check_cuda_inputs(
        {"x": x, "ids": ids, "w": w, "keep": keep, "wg": wg, "wu": wu, "wd": wd},
        {"x": tuple(DTYPE_CODES), "ids": (torch.int64,), "w": (torch.float32,),
         "keep": (torch.bool,), "wg": wt, "wu": wt, "wd": wt})
    C = tile_columns(x.dtype)
    if D % C or F % C:
        raise ValueError(f"moe_experts takes D and F in multiples of {C} in {x.dtype}, "
                         f"got D {D}, F {F}")
    up, down = plans(T, k, D, F, C, _sm_count(x.device))
    h = torch.empty((T, k, F), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.data_ptr(), ids.data_ptr(), w.data_ptr(), keep.data_ptr(),
                      wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), h.data_ptr(), y.data_ptr(),
                      T, k, D, F, up, down, DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"moe_experts launch failed: cudaError {err}")
    moe_experts.launches += 1
    return y


def moe_experts(x, ids, w, keep, wg, wu, wd):
    """y (T, D) from the routed pairs; see the module docstring."""
    T, D = x.shape
    k = ids.shape[-1]
    E, _, F = wg.shape
    if (tuple(ids.shape) != (T, k) or tuple(w.shape) != (T, k) or keep.numel() != T * k
            or tuple(wg.shape) != (E, D, F) or tuple(wu.shape) != (E, D, F)
            or tuple(wd.shape) != (E, F, D)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, ids {tuple(ids.shape)}, w {tuple(w.shape)}, "
            f"keep {tuple(keep.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, "
            f"wd {tuple(wd.shape)}")
    keep = keep.reshape(T, k)
    if x.device.type == "cpu":
        return moe_experts_ref(x, ids, w, keep, wg, wu, wd)
    if not is_concrete_cuda(x):
        raise ValueError(f"no moe_experts for {type(x).__name__} on {x.device}")
    check_no_autograd("moe_experts", {"x": x, "wg": wg, "wu": wu, "wd": wd})
    return _launch(x, ids, w, keep, wg, wu, wd)


moe_experts.launches = 0
