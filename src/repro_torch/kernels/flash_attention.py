"""Causal / sliding-window GQA flash attention (prefill): wrapper of the CUDA
kernel in `csrc/flash_attention.cu`, which replaces the TPU Pallas kernel
`repro/kernels/flash_attention.py`.

q (B, S, H, hd); k, v (B, S, K, hd) with H = K * G; any S (tails are
masked in the kernel; the TPU kernel needed S to be a block multiple).

A CPU tensor runs the plain version (`ref.flash_attention_ref`); a CUDA
tensor launches the kernel of its dtype on the current stream, or raises:
bfloat16 runs the tensor-core kernel, float32 the CUDA-core one (tensor-core
products would miss fp32's tolerance).  There is no fallback between them.
`flash_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import DTYPE_CODES, HEAD_DIMS, check_cuda_inputs
from repro_torch.kernels.ref import flash_attention_ref


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, K, hd). Returns (B, S, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if (tuple(k.shape) != (B, S, K, hd) or tuple(v.shape) != tuple(k.shape)
            or H % K):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    kv = (q.dtype,)
    check_cuda_inputs({"q": q, "k": k, "v": v},
                      {"q": tuple(DTYPE_CODES), "k": kv, "v": kv})
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, S, H, K, hd, int(causal), int(window), DTYPE_CODES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
