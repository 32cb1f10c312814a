"""Causal / sliding-window GQA flash attention (prefill): wrapper of the CUDA
kernel in `csrc/flash_attention.cu`, which replaces the TPU Pallas kernel
`repro/kernels/flash_attention.py`.

q (B, S, H, hd); k, v (B, S, K, hd) with H = K * G and hd in `HEAD_DIMS`;
any S (tails are masked in the kernel; the TPU kernel needed S to be a
block multiple).

A CPU tensor runs the plain version (`ref.flash_attention_ref`); a CUDA
tensor launches the kernel of its dtype on the current stream, or raises:
bfloat16 runs the tensor-core kernel, float32 the CUDA-core one (tensor-core
products would miss fp32's tolerance).  There is no fallback between them.
The kernel has no backward, so a CUDA call that autograd would record raises.
`flash_attention.launches` counts kernel launches.

A plain CUDA tensor launches directly (a DTensor's local shards reach the
wrapper as such through `local_map`, `models.sharded`).  Any other (a
FakeTensor, a meta tensor) goes through the operator
``repro_torch::flash_attention`` (`torch.library.custom_op`), whose fake
gives the output's shape and launches nothing, and whose FLOP formula (for
`torch.utils.flop_counter` and `roofline.analysis`) counts the visible
(query, key) pairs.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (DTYPE_CODES, check_cuda_inputs,
                                                check_no_autograd, is_concrete_cuda)
from repro_torch.kernels.ref import flash_attention_ref

# head dims the kernel is instantiated for (RecurrentGemma's local attention
# is hd 256; the paged decode kernel keeps its own, smaller set)
HEAD_DIMS = (32, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention computes: causal and windowed ones only."""
    if not causal:
        return sum(S - max(0, q - window + 1) for q in range(S)) if window else S * S
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


def _launch(q, k, v, causal: bool, window: int):
    """Check the operands and launch the kernel on the current stream."""
    B, S, H, hd = q.shape
    kv = (q.dtype,)
    check_cuda_inputs({"q": q, "k": k, "v": v},
                      {"q": tuple(DTYPE_CODES), "k": kv, "v": kv})
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, S, H, k.shape[2], hd, int(causal), int(window),
                      DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int) -> torch.Tensor:
    """The kernel as an operator, so that it traces under `FakeTensorMode`
    and on meta tensors (its fake gives the output's shape only and launches
    nothing)."""
    return _launch(q, k, v, causal, window)


_flash_op.register_fake(lambda q, k, v, causal, window: torch.empty_like(q))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    """Q.K^T and P.V over the visible (query, key) pairs: 4 B H hd pairs."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * visible_pairs(S, causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, K, hd). Returns (B, S, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):  # meta: shapes only, through the fake
        raise ValueError(f"no flash_attention for device {q.device}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if (tuple(k.shape) != (B, S, K, hd) or tuple(v.shape) != tuple(k.shape)
            or H % K):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    check_no_autograd("flash_attention", {"q": q, "k": k, "v": v})
    if is_concrete_cuda(q):
        return _launch(q, k, v, bool(causal), int(window))
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), int(window))


flash_attention.launches = 0
