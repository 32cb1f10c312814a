"""Rotary embedding and K/V write of a paged decode step's layer: wrapper of
the CUDA kernel in `csrc/rope_kv_write.cu`, which replaces no TPU kernel
(its source note says why it exists and what bounds it).

Layout:
  q         (B, H, hd)      the layer's query heads
  k, v      (B, K, hd)      its new key and value rows
  cos, sin  (B, hd / 2)     float32, the step's `common.rope_table`
  row       (B,) int64      each sequence's row of a layer's (P * T, K, hd) pages
  k_pages, v_pages (P, T, K, hd)  one layer's pages, written in place
Returns the roped q (B, H, hd); the roped k and the v rows land in the
pages at `row`.  That is `ref.rope_kv_write_ref`: `common.rope_apply` on q
and k, then two `index_copy_`, to the bit.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel on
the current stream, or raises (so does a call that autograd would record,
and any dtype but bfloat16 for q, k, v and the pages).  The wrapper checks
devices, dtypes, shapes and contiguity, never values: it reads nothing back
from the device, so a decode step stays free of host syncs and captures.
The grid comes from the static shapes alone.  `rope_kv_write.launches`
counts calls, one a layer of a llama-style paged decode step.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (check_cuda_inputs, check_no_autograd,
                                                 is_concrete_cuda)
from repro_torch.kernels.ref import rope_kv_write_ref


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("rope_kv_write").rope_kv_write_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, cos, sin, row, k_pages, v_pages):
    """Check the operands and launch the kernel on the current stream."""
    B, H, hd = q.shape
    K = k.shape[1]
    bf = (torch.bfloat16,)
    check_cuda_inputs(
        {"q": q, "k": k, "v": v, "cos": cos, "sin": sin, "row": row, "k_pages": k_pages,
         "v_pages": v_pages},
        {"q": bf, "k": bf, "v": bf, "cos": (torch.float32,), "sin": (torch.float32,),
         "row": (torch.int64,), "k_pages": bf, "v_pages": bf})
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                      row.data_ptr(), out.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      B, H, K, hd, stream)
    if err:
        raise RuntimeError(f"rope_kv_write launch failed: cudaError {err}")
    rope_kv_write.launches += 1
    return out


def rope_kv_write(q, k, v, cos, sin, row, k_pages, v_pages):
    """The roped q (B, H, hd), k and v written to their pages; see the
    module docstring."""
    ok = q.dim() == 3 and k_pages.dim() == 4
    if ok:
        B, _, hd = q.shape
        K = k_pages.shape[2]
        ok = (hd % 2 == 0 and tuple(k.shape) == tuple(v.shape) == (B, K, hd)
              and tuple(cos.shape) == tuple(sin.shape) == (B, hd // 2)
              and tuple(row.shape) == (B,) and k_pages.shape[3] == hd
              and v_pages.shape == k_pages.shape)
    if not ok:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"cos {tuple(cos.shape)}, sin {tuple(sin.shape)}, row {tuple(row.shape)}, "
            f"k_pages {tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    if q.device.type == "cpu":
        return rope_kv_write_ref(q, k, v, cos, sin, row, k_pages, v_pages)
    if not is_concrete_cuda(q):
        raise ValueError(f"no rope_kv_write for {type(q).__name__} on {q.device}")
    check_no_autograd("rope_kv_write", {"q": q, "k": k, "v": v})
    return _launch(q, k, v, cos, sin, row, k_pages, v_pages)


rope_kv_write.launches = 0
