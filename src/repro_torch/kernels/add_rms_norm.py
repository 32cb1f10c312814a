"""Residual add and RMSNorm of a paged decode step: wrapper of the CUDA
kernel in `csrc/add_rms_norm.cu`, which replaces no TPU kernel (its source
note says why it exists and what bounds it).

Layout:
  h      (B, S, D)   the residual stream (S 1 in the decode step)
  delta  (B, S, D)   a sub-block's output, or None: norm only
  scale  (D,)        float32, the norm's scale (applied as 1 + scale)
Returns (h_new, x): h_new = h + delta (h itself where delta is None) and
x = `common.rms_norm(h_new, scale, eps)`.  That is `ref.add_rms_norm_ref`;
the kernel's h_new is equal to it to the bit, and its x differs from it only
by the order of the sum of squares over D: at most one bfloat16 step an
element.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel on
the current stream, or raises (so does any dtype but bfloat16 for h and
delta).  On every device the wrapper raises on mismatched shapes or dtypes,
a non-contiguous operand, a D that is not a multiple of 8 (or above 8192)
and a call that autograd would record.  It checks devices, dtypes, shapes
and contiguity, never values: it reads nothing back from the device, so a
decode step stays free of host syncs and captures.  The grid comes from the
static shapes alone.  `add_rms_norm.launches` counts calls, 2 L + 1 a paged
decode step of L layers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (check_cuda_inputs, check_no_autograd,
                                                 is_concrete_cuda)
from repro_torch.kernels.ref import add_rms_norm_ref

MAX_D = 8192  # 1,024 threads of 8 values


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("add_rms_norm").add_rms_norm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(h, delta, scale):
    """Shapes, dtypes and contiguity the kernel and its plain version share."""
    ok = h.dim() == 3 and (delta is None or tuple(delta.shape) == tuple(h.shape))
    D = h.shape[-1] if ok else 0
    if not (ok and tuple(scale.shape) == (D,)):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if D % 8 or D > MAX_D:
        raise ValueError(f"width {D}: the kernel takes a multiple of 8 up to {MAX_D}")
    if delta is not None and delta.dtype != h.dtype:
        raise TypeError(f"delta has dtype {delta.dtype}, expected h's {h.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale has dtype {scale.dtype}, expected torch.float32")
    for name, t in (("h", h), ("delta", delta), ("scale", scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(h, delta, scale, eps):
    """Check the operands and launch the kernel on the current stream."""
    bf = (torch.bfloat16,)
    operands = {"h": h, "scale": scale, **({} if delta is None else {"delta": delta})}
    check_cuda_inputs(operands, {"h": bf, "delta": bf, "scale": (torch.float32,)})
    x = torch.empty_like(h)
    h_new = h if delta is None else torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _launcher()(h.data_ptr(), None if delta is None else delta.data_ptr(),
                      scale.data_ptr(), h_new.data_ptr(), x.data_ptr(),
                      h.shape[0] * h.shape[1], h.shape[2], eps, stream)
    if err:
        raise RuntimeError(f"add_rms_norm launch failed: cudaError {err}")
    add_rms_norm.launches += 1
    return h_new, x


def add_rms_norm(h, delta, scale, eps):
    """(h + delta, rms_norm(h + delta, scale, eps)); see the module
    docstring."""
    _check(h, delta, scale)
    check_no_autograd("add_rms_norm", {"h": h, "scale": scale,
                                       **({} if delta is None else {"delta": delta})})
    if h.device.type == "cpu":
        return add_rms_norm_ref(h, delta, scale, eps)
    if not is_concrete_cuda(h):
        raise ValueError(f"no add_rms_norm for {type(h).__name__} on {h.device}")
    return _launch(h, delta, scale, eps)


add_rms_norm.launches = 0
