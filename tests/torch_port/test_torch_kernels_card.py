"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the `cuda_device` fixture and skips without a CUDA
device.  The file imports neither JAX nor the reference package, so it also
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

Shapes are tests/test_kernels.py's PAGED_CASES / FLASH_CASES (copied here,
since that module imports JAX) plus llama3.2-1b's main-path shapes.
Tolerances are that file's: 2e-5 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
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
