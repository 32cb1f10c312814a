"""E-Attention paged decode attention: wrapper of the CUDA kernel in
`csrc/paged_attention.cu`, which replaces the TPU Pallas kernel
`repro/kernels/paged_attention.py`.

Layout:
  q            (B, H, hd)      one query token per sequence, H = K * G
  k/v_pages    (P, T, K, hd)   one layer's view of the shared KV slab
  block_tables (B, N) int32    physical page ids per sequence
  lengths      (B,) int32      live context per sequence

A CPU tensor runs the plain version (`ref.paged_attention_ref`); a CUDA
tensor launches the kernel on the current stream, or raises.  The wrapper
checks devices, dtypes, shapes and contiguity, never values: it reads
nothing back from the device, so a decode step stays free of host syncs.
The kernel is split-KV (flash-decoding): its grid and float32 scratch for
the splits' partial softmax states come from `split_plan`, that is from the
table's static shape alone.  One call makes two launches (the splits, then
their combination); `paged_attention.launches` counts calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
SPLIT_TARGET = 64  # tokens per split-KV block, rounded up to whole pages


def split_plan(N: int, T: int) -> tuple[int, int]:
    """(split_tokens, splits) of the split-KV grid for tables of N pages of T
    tokens.  Fixed by the table's static shape, never by the lengths, so the
    host reads nothing back from the device to launch a decode step."""
    split_tokens = T * -(-SPLIT_TARGET // T)
    return split_tokens, -(-N * T // split_tokens)


def split_scratch_shapes(B: int, H: int, hd: int, splits: int) -> dict[str, tuple]:
    """Shapes of the float32 scratch of one call: each split's unnormalised
    P.V row and its softmax max and sum, per (sequence, query head)."""
    return {"acc": (B, H, splits, hd), "m": (B, H, splits), "l": (B, H, splits)}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_cuda_inputs(tensors: dict[str, torch.Tensor], dtypes: dict[str, tuple]):
    """Device, dtype, contiguity and 16-byte alignment of kernel operands."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, hd) -> (B, H, hd). See module docstring for page layout."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention for device {q.device}")
    B, H, hd = q.shape
    P, T, K, hd_k = k_pages.shape
    N = block_tables.shape[1]
    if (tuple(v_pages.shape) != tuple(k_pages.shape) or hd_k != hd or H % K
            or tuple(block_tables.shape) != (B, N) or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)}, tables {tuple(block_tables.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    kv = (q.dtype,)
    check_cuda_inputs(
        {"q": q, "k_pages": k_pages, "v_pages": v_pages,
         "block_tables": block_tables, "lengths": lengths},
        {"q": tuple(DTYPE_CODES), "k_pages": kv, "v_pages": kv,
         "block_tables": (torch.int32,), "lengths": (torch.int32,)})
    split_tokens, splits = split_plan(N, T)
    part = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
            for name, shape in split_scratch_shapes(B, H, hd, splits).items()}
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      part["acc"].data_ptr(), part["m"].data_ptr(), part["l"].data_ptr(),
                      B, H, K, hd, T, N, split_tokens, splits, DTYPE_CODES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
