"""E-Attention paged decode attention: wrapper of the CUDA kernel in
`csrc/paged_attention.cu`, which replaces the TPU Pallas kernel
`repro/kernels/paged_attention.py`.

Layout:
  q            (B, H, hd)      one query token per sequence, H = K * G
  k/v_pages    (P, T, K, hd)   one layer's view of the shared KV slab
  block_tables (B, N) int32    physical page ids per sequence
  lengths      (B,) int32      live context per sequence

A CPU tensor runs the plain version (`ref.paged_attention_ref`); a CUDA
tensor launches the kernel on the current stream, or raises (so does a call
that autograd would record: the kernel has no backward).  The wrapper
checks devices, dtypes, shapes and contiguity, never values: it reads
nothing back from the device, so a decode step stays free of host syncs.
One call is one launch (the source note of `csrc/paged_attention.cu`
has the design): its grid comes from `split_plan`, that is from the static
shapes and the card's SM count alone, and blocks of a sequence with several
live splits leave float32 partials in per-call scratch and merge them in
the last of them, counted by a per-device buffer of int32 tickets
(`_counters`) that every launch leaves at 0.  bfloat16 runs on the tensor
cores (`mma.sync`, the G query rows of a kv head padded to 16; G 1 too: its
tile of one real row beat CUDA-core dot products 2.3-2.6x on an H100,
PERF.md), float32 on the CUDA cores (TF32 would miss 2e-5).
`paged_attention.launches` counts calls.  A plain CUDA tensor launches directly; any other (a FakeTensor, a
meta tensor) goes through the operator ``repro_torch::paged_attention``
(`torch.library.custom_op`), whose fake gives the output's shape and
launches nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref, paged_latent_attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
ROWS = 16  # query rows of a block: one mma tile; G > 16 takes several blocks a kv head
BLOCKS_PER_SM = 4  # the split plan's ceiling: blocks a full table may launch, per SM
MAX_SPLITS = 32  # the split plan's ceiling: partials the last block of a sequence merges
COUNTERS_MIN = 4096  # ticket counters allocated at first use
# latent mode (MLA decode): the (q/k, v) widths of its one instance, and the
# blocks a full table launches per SM (one kv head: the splits are the grid)
LATENT_WIDTHS = (576, 512)
LATENT_BLOCKS_PER_SM = 2
LATENT_CHUNK = 64  # tokens a ring stage of the latent mode holds


def row_groups(G: int) -> int:
    """Blocks a kv head's G query rows take (16 rows each)."""
    return -(-G // ROWS)


def split_plan(B: int, K: int, N: int, T: int, sms: int) -> tuple[int, int]:
    """(split_tokens, splits) of the grid for B sequences of K kv-head blocks
    (kv heads times `row_groups`) over tables of N pages of T tokens, on a
    card of `sms` SMs.  Splits are whole pages, as fine as keeps a full
    table's B * K * splits blocks within BLOCKS_PER_SM * sms and a sequence's
    splits within MAX_SPLITS (one page at the least; one split when B * K
    alone fills the card).  Finer splits put more blocks to work but give the
    merging block more partials to read: on an H100 the two ceilings came out
    fastest at every served shape but G 7-8 at 528 tokens, where they are
    within 0.0001 ms of the fastest (PERF.md, `scripts/k1_split_sweep.py`).
    Fixed by the
    static shapes, never by the lengths, so the host reads nothing back from
    the device to launch a decode step."""
    most = max(1, min(MAX_SPLITS, BLOCKS_PER_SM * sms // (B * K)))  # splits a (b, kv head)
    pages = -(-N // most)
    return pages * T, -(-N // pages)


def latent_split_plan(B: int, groups: int, N: int, T: int, sms: int) -> tuple[int, int]:
    """(split_tokens, splits) of the latent mode's grid: one kv head, so a
    sequence's splits are what fills the card.  A full table of N pages
    launches about LATENT_BLOCKS_PER_SM blocks an SM (at least one ring
    stage of tokens a split); a sequence at half its table's capacity
    keeps about one block on each SM.  The partials merge in a second
    kernel, over the live splits in parallel, so their number has no
    ceiling.  Fixed by the static shapes, as `split_plan`."""
    most = max(1, LATENT_BLOCKS_PER_SM * sms // (B * groups))
    pages = max(-(-N // most), min(N, -(-LATENT_CHUNK // T)))
    return pages * T, -(-N // pages)


def split_scratch_shapes(B: int, H: int, hd: int, splits: int) -> dict[str, tuple]:
    """Shapes of the float32 scratch of one call: each split's unnormalised
    P.V row and its softmax max and sum, per (sequence, query head)."""
    return {"acc": (B, H, splits, hd), "m": (B, H, splits), "l": (B, H, splits)}


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    alloc = lib.paged_attention_counters
    alloc.argtypes = [ctypes.c_int, ctypes.c_void_p]
    alloc.restype = ctypes.c_void_p
    return fn, alloc


@functools.lru_cache(maxsize=None)
def _latent_launcher():
    fn = build.library("paged_attention").paged_latent_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: dict[int, tuple[int, int]] = {}  # device index -> (address, capacity)


def _counters(device: torch.device, n: int, stream: int) -> int:
    """Address of at least n ticket counters on `device` that read 0.

    One buffer per device, allocated by the kernel's library (cudaMalloc,
    outside PyTorch's caching allocator, so no graph pool or memory reading
    sees it) with its memset queued on `stream`, outside any capture; each
    launch leaves its counters at 0 again, and launches on it run in the
    order of the compute stream.  A larger buffer replaces a smaller one;
    the smaller stays allocated, since a captured graph holds its address."""
    addr, cap = _COUNTERS.get(device.index, (0, 0))
    if n <= cap:
        return addr
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"paged_attention needs {n} ticket counters but has {cap}: call it once "
            "outside the capture at this batch first")
    cap = max(n, 2 * cap, COUNTERS_MIN)
    with torch.cuda.device(device):
        addr = _launcher()[1](cap, stream)
    if not addr:
        raise RuntimeError(f"paged_attention could not allocate {cap} ticket counters")
    _COUNTERS[device.index] = (addr, cap)
    return addr


def check_no_autograd(name: str, tensors: dict[str, torch.Tensor]):
    """The kernels have no backward: a call that autograd would record raises
    instead of returning an output detached from its inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or with "
            "inputs that do not require grad (the training path runs the plain "
            "attention, as the reference's loss does)")


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


def is_concrete_cuda(t: torch.Tensor) -> bool:
    """A plain CUDA tensor with storage (not a DTensor, a FakeTensor or a
    meta tensor): the wrappers launch on it directly, without the
    operator's dispatch."""
    return type(t) is torch.Tensor and t.device.type == "cuda"


def _launch(q, k_pages, v_pages, block_tables, lengths):
    """Check the operands and launch the kernel on the current stream."""
    B, H, hd = q.shape
    P, T, K, _ = k_pages.shape
    N = block_tables.shape[1]
    kv = (q.dtype,)
    check_cuda_inputs(
        {"q": q, "k_pages": k_pages, "v_pages": v_pages, "block_tables": block_tables,
         "lengths": lengths},
        {"q": tuple(DTYPE_CODES), "k_pages": kv, "v_pages": kv,
         "block_tables": (torch.int32,), "lengths": (torch.int32,)})
    blocks = K * row_groups(H // K)
    split_tokens, splits = split_plan(B, blocks, N, T, _sm_count(q.device))
    part = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
            for name, shape in split_scratch_shapes(B, H, hd, splits).items()}
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, B * blocks, stream)
    err = _launcher()[0](q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                         block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                         part["acc"].data_ptr(), part["m"].data_ptr(), part["l"].data_ptr(),
                         counters, B, H, K, hd, T, N, split_tokens, splits,
                         DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              block_tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The kernel as an operator (as `flash_attention`'s): its fake gives the
    output's shape only and launches nothing."""
    return _launch(q, k_pages, v_pages, block_tables, lengths)


_paged_op.register_fake(lambda q, k_pages, v_pages, block_tables, lengths:
                        torch.empty_like(q))


@register_flop_formula(torch.ops.repro_torch.paged_attention)
def _paged_flops(q_shape, k_shape, v_shape, tables_shape, lengths_shape, *args,
                 **kwargs) -> int:
    """Q.K^T and P.V over every slot the tables can hold (N pages of T
    tokens): the lengths are device values, so a count from shapes takes
    the table's capacity, an upper bound of the work."""
    B, H, hd = q_shape
    return 4 * B * H * hd * tables_shape[1] * k_shape[1]


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, H, hd) -> (B, H, hd). See module docstring for page layout.

    On CUDA, calls on one device must run one after another: they share the
    device's ticket counters, so two calls in flight at once on two streams
    would mix their tickets.  The port issues every call on its compute
    stream (a captured call replays there too)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type not in ("cuda", "meta"):  # meta: shapes only, through the fake
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
    check_no_autograd("paged_attention", {"q": q, "k_pages": k_pages, "v_pages": v_pages})
    if is_concrete_cuda(q):
        return _launch(q, k_pages, v_pages, block_tables, lengths)
    return torch.ops.repro_torch.paged_attention(q, k_pages, v_pages, block_tables, lengths)


paged_attention.launches = 0


def _launch_latent(q, pages, block_tables, lengths, v_dim: int, scale: float):
    """Check the operands and launch the latent mode on the current stream:
    the split kernel, and where the plan has several splits the merge."""
    B, H, W = q.shape
    P, T, _, _ = pages.shape
    N = block_tables.shape[1]
    check_cuda_inputs(
        {"q": q, "pages": pages, "block_tables": block_tables, "lengths": lengths},
        {"q": (torch.bfloat16,), "pages": (torch.bfloat16,),
         "block_tables": (torch.int32,), "lengths": (torch.int32,)})
    split_tokens, splits = latent_split_plan(B, row_groups(H), N, T, _sm_count(q.device))
    part = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
            for name, shape in split_scratch_shapes(B, H, v_dim, splits).items()}
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    err = _latent_launcher()(q.data_ptr(), pages.data_ptr(), block_tables.data_ptr(),
                             lengths.data_ptr(), out.data_ptr(), part["acc"].data_ptr(),
                             part["m"].data_ptr(), part["l"].data_ptr(), B, H, W, v_dim, T, N,
                             split_tokens, splits, scale,
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged latent attention launch failed: cudaError {err}")
    paged_attention.launches += 1
    paged_attention.latent_launches += 1
    return out


def paged_latent_attention(q, pages, block_tables, lengths, *, v_dim: int, scale: float):
    """K1's latent mode, the decode attention of absorbed MLA: q (B, H, W)
    against one latent head of pages (P, T, 1, W), V the first `v_dim`
    columns of the same rows, scores at `scale` -> (B, H, v_dim).

    A CPU tensor runs the plain version (`ref.paged_latent_attention_ref`);
    a CUDA tensor launches the kernel's latent instance (bfloat16 at
    `LATENT_WIDTHS` alone; the source note of `csrc/paged_attention.cu` has
    its design), or raises.  Counted in `paged_attention.launches` and in
    `paged_attention.latent_launches`."""
    if q.device.type == "cpu":
        return paged_latent_attention_ref(q, pages, block_tables, lengths, v_dim=v_dim,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged latent attention for device {q.device}")
    B, H, W = q.shape
    P, T, K, W_p = pages.shape
    N = block_tables.shape[1]
    if (K != 1 or W_p != W or tuple(block_tables.shape) != (B, N)
            or tuple(lengths.shape) != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages {tuple(pages.shape)}, "
            f"tables {tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    if (W, v_dim) != LATENT_WIDTHS:
        raise ValueError(f"latent widths ({W}, {v_dim}) are not {LATENT_WIDTHS}")
    check_no_autograd("paged_latent_attention", {"q": q, "pages": pages})
    if not is_concrete_cuda(q):
        raise ValueError("paged latent attention launches on plain CUDA tensors only")
    return _launch_latent(q, pages, block_tables, lengths, v_dim, float(scale))


paged_attention.latent_launches = 0
