"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the `cuda_device` fixture and skips without a CUDA
device.  The file imports neither JAX nor the reference package, so it also
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

Shapes are tests/test_kernels.py's PAGED_CASES / FLASH_CASES (copied here,
since that module imports JAX) plus llama3.2-1b's main-path shapes, and the
edges of the kernels' designs: lengths at and around the split-KV
boundaries, full tables and long contexts (paged decode); S at and around
the 64-row tiles, windows and head dims 32 / 64 / 128 (bf16 prefill).
Tolerances are that file's: 2e-5 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import split_plan  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]

# (B, H, K, hd, T, P, N); the last is llama3.2-1b's decode (H 32 / K 8, hd 64)
PAGED_CASES = [
    (1, 4, 4, 64, 16, 16, 4),
    (4, 8, 2, 64, 16, 64, 6),
    (2, 16, 1, 128, 32, 16, 4),
    (3, 32, 4, 128, 16, 32, 8),
    (2, 8, 8, 128, 64, 8, 2),
    (4, 32, 8, 64, 16, 260, 64),
]
# (B, S, H, K, hd, causal, window); the last is llama3.2-1b's prefill
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 2, 64, True, 100),
    (1, 128, 8, 1, 32, False, 0),
    (2, 512, 2, 2, 64, True, 64),
    (1, 256, 16, 1, 128, True, 0),
    (4, 512, 32, 8, 64, True, 0),
]

pytestmark = pytest.mark.cuda


def randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, getattr(torch, dtype))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain(cuda_device, case, dtype):
    B, H, K, hd, T, P, N = case
    rng = np.random.default_rng(sum(case))
    q = randn(rng, (B, H, hd), dtype, cuda_device)
    kp = randn(rng, (P, T, K, hd), dtype, cuda_device)
    vp = randn(rng, (P, T, K, hd), dtype, cuda_device)
    tables = torch.from_numpy(rng.integers(0, P, (B, N)).astype(np.int32)).to(cuda_device)
    lengths = rng.integers(1, N * T + 1, (B,)).astype(np.int32)
    lengths[0] = 1  # a single-token context in every case
    lengths = torch.from_numpy(lengths).to(cuda_device)
    n0 = ops.paged_attention.launches
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


def test_paged_kernel_never_reads_table_entries_past_the_length(cuda_device):
    """Entries at or past ceil(length / T) hold ids far outside the slab: the
    kernel must give the same output as with valid ids there."""
    B, H, K, hd, T, P, N = 3, 8, 2, 64, 16, 40, 9
    rng = np.random.default_rng(11)
    q = randn(rng, (B, H, hd), "float32", cuda_device)
    kp = randn(rng, (P, T, K, hd), "float32", cuda_device)
    vp = randn(rng, (P, T, K, hd), "float32", cuda_device)
    tables = torch.from_numpy(rng.integers(0, P, (B, N)).astype(np.int32))
    lens = [1, 33, 100]
    poisoned = tables.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // T):] = 1 << 30
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, poisoned.to(cuda_device), lengths)
    ref = paged_attention_ref(q, kp, vp, tables.to(cuda_device), lengths)
    assert max_err(out, ref) < TOL["float32"]


def paged_inputs(rng, B, H, K, hd, T, N, dtype, dev, P=None):
    P = P or B * N + 3
    q = randn(rng, (B, H, hd), dtype, dev)
    kp = randn(rng, (P, T, K, hd), dtype, dev)
    vp = randn(rng, (P, T, K, hd), dtype, dev)
    tables = torch.from_numpy(rng.permutation(P)[: B * N].reshape(B, N).astype(np.int32))
    return q, kp, vp, tables.to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (32, 8), (32, 4)])  # G = 1, 4, 8
def test_paged_kernel_at_split_boundaries(cuda_device, dtype, hd, H, K):
    """Lengths at, one before and one past the split-KV boundaries, length 1,
    and a full table (every split live)."""
    T, N = 16, 16
    st, splits = split_plan(N, T)
    assert splits > 2
    lens = [1, st - 1, st, st + 1, 2 * st - 1, 2 * st + 1, N * T]
    rng = np.random.default_rng(hd + H + K)
    q, kp, vp, tables = paged_inputs(rng, len(lens), H, K, hd, T, N, dtype, cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [16, 32, 48])  # 48: splits of a page count, not 64 tokens
def test_paged_kernel_long_context_at_batch_1(cuda_device, dtype, T):
    """One long conversation (llama3.2-1b's heads): many splits for one
    sequence, the last one partial."""
    N = 4096 // T
    rng = np.random.default_rng(T)
    q, kp, vp, tables = paged_inputs(rng, 1, 32, 8, 64, T, N, dtype, cuda_device)
    lengths = torch.tensor([N * T - 96], dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


def test_paged_kernel_zero_length_gives_zeros(cuda_device):
    rng = np.random.default_rng(4)
    q, kp, vp, tables = paged_inputs(rng, 2, 8, 2, 64, 16, 8, "bfloat16", cuda_device)
    lengths = torch.tensor([0, 70], dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert bool((out[0] == 0).all())
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_dead_splits_read_no_table_entry(cuda_device, dtype):
    """A split that starts at or past the length reads no table entry: entries
    of such splits hold ids far outside the slab, while every entry of the
    live splits stays valid (past the length too)."""
    T, N = 16, 20
    st, splits = split_plan(N, T)
    lens = [1, st, st + 1, 2 * st]
    rng = np.random.default_rng(12)
    q, kp, vp, tables = paged_inputs(rng, len(lens), 8, 2, 64, T, N, dtype, cuda_device)
    poisoned = tables.clone()
    for b, n in enumerate(lens):
        first_dead = -(-n // st) * (st // T)  # first entry of the first dead split
        poisoned[b, first_dead:] = 1 << 30
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, poisoned, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_kernel_bf16_at_tile_boundaries(cuda_device, S, hd):
    """The bf16 tensor-core kernel at S on both sides of its 64-row tiles."""
    rng = np.random.default_rng(S + hd)
    q = randn(rng, (2, S, 8, hd), "bfloat16", cuda_device)
    k = randn(rng, (2, S, 2, hd), "bfloat16", cuda_device)
    v = randn(rng, (2, S, 2, hd), "bfloat16", cuda_device)
    out = ops.flash_attention(q, k, v, causal=True)
    assert max_err(out, flash_attention_ref(q, k, v, causal=True)) < TOL["bfloat16"]


@pytest.mark.parametrize("H,K", [(8, 8), (32, 8), (32, 4)])  # G = 1, 4, 8
@pytest.mark.parametrize("causal,window", [(True, 64), (True, 100), (False, 0), (False, 80)])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_kernel_bf16_windows_and_heads(cuda_device, H, K, causal, window, hd):
    """Windows spanning several tiles (S > 2 x 64), non-causal, GQA groups."""
    S = 330
    rng = np.random.default_rng(H + K + window + hd)
    q = randn(rng, (1, S, H, hd), "bfloat16", cuda_device)
    k = randn(rng, (1, S, K, hd), "bfloat16", cuda_device)
    v = randn(rng, (1, S, K, hd), "bfloat16", cuda_device)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert max_err(out, ref) < TOL["bfloat16"]


def test_flash_kernel_bf16_long_prompt(cuda_device):
    """One 4k-token prompt at llama3.2-1b's heads."""
    rng = np.random.default_rng(4096)
    q = randn(rng, (1, 4096, 32, 64), "bfloat16", cuda_device)
    k = randn(rng, (1, 4096, 8, 64), "bfloat16", cuda_device)
    v = randn(rng, (1, 4096, 8, 64), "bfloat16", cuda_device)
    out = ops.flash_attention(q, k, v, causal=True)
    assert max_err(out, flash_attention_ref(q, k, v, causal=True)) < TOL["bfloat16"]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tail", [0, 3])
def test_flash_kernel_matches_plain(cuda_device, case, dtype, tail):
    B, S, H, K, hd, causal, window = case
    S -= tail  # tail > 0: S is no multiple of the kernel's 64-row tile
    rng = np.random.default_rng(sum(case[:5]) + tail)
    q = randn(rng, (B, S, H, hd), dtype, cuda_device)
    k = randn(rng, (B, S, K, hd), dtype, cuda_device)
    v = randn(rng, (B, S, K, hd), dtype, cuda_device)
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert max_err(out, ref) < TOL[dtype]


def test_wrappers_reject_what_the_kernels_cannot_take(cuda_device):
    q = torch.zeros((2, 8, 64), device=cuda_device)
    kp = torch.zeros((4, 16, 2, 64), device=cuda_device)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    lengths = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):  # int64 tables
        ops.paged_attention(q, kp, kp, tables.long(), lengths)
    with pytest.raises(TypeError):  # K/V dtype differs from q
        ops.paged_attention(q, kp.bfloat16(), kp.bfloat16(), tables, lengths)
    with pytest.raises(ValueError):  # a CPU operand
        ops.paged_attention(q, kp, kp, tables.cpu(), lengths)
    with pytest.raises(ValueError):  # head dim the kernel has no instance for
        ops.flash_attention(*(torch.zeros((1, 8, 2, 48), device=cuda_device),) * 3)
