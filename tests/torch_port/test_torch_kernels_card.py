"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the `cuda_device` fixture and skips without a CUDA
device.  The file imports neither JAX nor the reference package, so it also
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

Shapes are tests/test_kernels.py's PAGED_CASES / FLASH_CASES (copied here,
since that module imports JAX) plus llama3.2-1b's main-path shapes, and the
edges of the kernels' designs: lengths at and around the split boundaries of
`split_plan` on this card, full tables and long contexts, one live split
(written directly) and several (merged by the last block), the ticket
counters across graph replays, G of 1 to 32 (paged decode); S at and
around the 64-row tiles, windows and head dims 32 / 64 / 128 (bf16 prefill).
Tolerances are that file's: 2e-5 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import row_groups, split_plan  # noqa: E402
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


def plan(dev, B, H, K, N, T):
    """The kernel's (split_tokens, splits) for these shapes on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return split_plan(B, K * row_groups(H // K), N, T, sms)


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
    st, splits = plan(cuda_device, 7, H, K, N, T)
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
    st, splits = plan(cuda_device, 4, 8, 2, N, T)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K", [(28, 4), (16, 1), (32, 1)])  # G = 7, 16, 32 (two row groups)
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_kernel_gqa_groups(cuda_device, dtype, H, K, hd):
    """G 7 (qwen2-vl-7b), 16 (one full mma tile) and 32 (two blocks a kv
    head) at lengths on both sides of the split boundaries and a full
    table."""
    T, N = 16, 32
    st, splits = plan(cuda_device, 5, H, K, N, T)
    lens = [1, st, st + 1, 3 * st - 1, N * T]
    rng = np.random.default_rng(H + K + hd)
    q, kp, vp, tables = paged_inputs(rng, len(lens), H, K, hd, T, N, dtype, cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


@pytest.mark.parametrize("H,K", [(32, 32), (32, 8), (28, 4)])  # G = 1, 4, 7
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_paged_kernel_bf16_tensor_core_rows(cuda_device, H, K, hd):
    """bfloat16 takes the tensor cores at every G, G 1 (one real row of the
    16-row tile) too: within the bf16 tolerance over one and several
    splits."""
    T, N = 16, 16
    st, _ = plan(cuda_device, 3, H, K, N, T)
    lens = [st - 3, 2 * st + 5, N * T]
    rng = np.random.default_rng(H + K + hd + 3)
    q, kp, vp, tables = paged_inputs(rng, len(lens), H, K, hd, T, N, "bfloat16", cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_single_live_split_writes_directly(cuda_device, dtype):
    """Every sequence within its first split: each block writes the output
    itself and no ticket is taken (the counters stay 0: the next call,
    with several live splits, is right)."""
    B, H, K, hd, T, N = 4, 32, 8, 64, 16, 64
    st, splits = plan(cuda_device, B, H, K, N, T)
    assert splits > 1
    rng = np.random.default_rng(21)
    q, kp, vp, tables = paged_inputs(rng, B, H, K, hd, T, N, dtype, cuda_device)
    for lens in ([1, st // 2, st - 1, st], [st + 1, 2 * st, N * T, 1]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        out = ops.paged_attention(q, kp, vp, tables, lengths)
        assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K", [(32, 8), (32, 4)])
def test_paged_kernel_poisoned_entries_past_the_length(cuda_device, dtype, H, K):
    """Table entries at or past ceil(length / T) hold ids far outside the
    slab, at lengths of one and of several live splits."""
    T, N = 16, 40
    st, _ = plan(cuda_device, 4, H, K, N, T)
    lens = [3, st + 7, 3 * st + 1, N * T - 5]
    rng = np.random.default_rng(H + K + 31)
    q, kp, vp, tables = paged_inputs(rng, len(lens), H, K, 128, T, N, dtype, cuda_device)
    poisoned = tables.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // T):] = 1 << 30
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = ops.paged_attention(q, kp, vp, poisoned, lengths)
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL[dtype]


def test_paged_kernel_is_one_launch_a_call(cuda_device):
    """At lengths of many live splits a call runs one CUDA kernel (the
    profiler's device events), and `launches` counts it once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, H, K, hd, T, N = 4, 32, 8, 64, 16, 64
    st, splits = plan(cuda_device, B, H, K, N, T)
    rng = np.random.default_rng(22)
    q, kp, vp, tables = paged_inputs(rng, B, H, K, hd, T, N, "bfloat16", cuda_device)
    lengths = torch.tensor([N * T, 3 * st + 1, 2 * st, 5], dtype=torch.int32,
                           device=cuda_device)
    ops.paged_attention(q, kp, vp, tables, lengths)  # built and warm
    torch.cuda.synchronize()
    n0 = ops.paged_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = ops.paged_attention(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Memset") and not e.name.startswith("Memcpy")]
    assert len(kernels) == 1 and "paged_attention_kernel" in kernels[0], kernels
    assert ops.paged_attention.launches == n0 + 1
    assert max_err(out, paged_attention_ref(q, kp, vp, tables, lengths)) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_graph_replays_reset_their_counters(cuda_device, dtype):
    """One call captured in a CUDA graph and replayed 120 times, lengths and
    tables rewritten in place between replays (one live split, several,
    length 0, a full table): each replay within the tolerance of the plain
    version, so the ticket counters read 0 at every replay; two replays of
    the same inputs are bitwise equal, and equal to the eager call."""
    B, H, K, hd, T, N = 3, 32, 4, 128, 16, 48
    rng = np.random.default_rng(23)
    q, kp, vp, tables = paged_inputs(rng, B, H, K, hd, T, N, dtype, cuda_device, P=4 * N)
    lengths = torch.tensor([N * T, 100, 1], dtype=torch.int32, device=cuda_device)
    eager = ops.paged_attention(q, kp, vp, tables, lengths)  # outside the capture first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        out = ops.paged_attention(q, kp, vp, tables, lengths)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    first = out.clone()
    graph.replay()
    assert torch.equal(out, first) and torch.equal(out, eager)
    for i in range(120):
        lens = rng.integers(0, N * T + 1, B).astype(np.int32)
        lens[i % B] = [0, 1, 17, N * T][i % 4]
        lengths.copy_(torch.from_numpy(lens))
        tables.copy_(torch.from_numpy(
            rng.permutation(4 * N)[: B * N].reshape(B, N).astype(np.int32)))
        graph.replay()
        ref = paged_attention_ref(q, kp, vp, tables, lengths)
        assert max_err(out, ref) < TOL[dtype], (i, lens)
    again = out.clone()
    graph.replay()
    assert torch.equal(out, again)


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


HD256_HEADS = [(16, 16), (16, 2), (16, 1)]  # G = 1, 8, 16 (RecurrentGemma: MQA, G 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K", HD256_HEADS)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300])
def test_flash_kernel_head_dim_256_at_tile_boundaries(cuda_device, dtype, H, K, S):
    """hd 256 (four 64-column blocks; P.V as two m64n128 halves in bf16) at S
    on both sides of the 64-row tiles, causal."""
    rng = np.random.default_rng(S + H + K)
    q = randn(rng, (1, S, H, 256), dtype, cuda_device)
    k = randn(rng, (1, S, K, 256), dtype, cuda_device)
    v = randn(rng, (1, S, K, 256), dtype, cuda_device)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert max_err(out, flash_attention_ref(q, k, v, causal=True)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K", HD256_HEADS)
@pytest.mark.parametrize("causal,window", [(True, 64), (True, 100), (False, 0), (False, 80)])
def test_flash_kernel_head_dim_256_windows(cuda_device, dtype, H, K, causal, window):
    """hd 256 with windows spanning several tiles and non-causal."""
    S = 330
    rng = np.random.default_rng(H + K + window)
    q = randn(rng, (1, S, H, 256), dtype, cuda_device)
    k = randn(rng, (1, S, K, 256), dtype, cuda_device)
    v = randn(rng, (1, S, K, 256), dtype, cuda_device)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert max_err(out, ref) < TOL[dtype]


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


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_flash_kernel_raises_under_autograd(cuda_device, needs_grad):
    """The kernel has no backward: a call autograd would record raises
    instead of returning an output detached from its inputs; the same call
    under no_grad launches."""
    rng = np.random.default_rng(5)
    q, k, v = (randn(rng, s, "bfloat16", cuda_device)
               for s in [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)])
    dict(q=q, k=k, v=v)[needs_grad].requires_grad_()
    n0 = ops.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention.launches == n0
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention.launches == n0 + 1 and not out.requires_grad


def test_paged_kernel_raises_under_autograd(cuda_device):
    rng = np.random.default_rng(6)
    q, kp, vp, tables = paged_inputs(rng, 2, 8, 2, 64, 16, 4, "bfloat16", cuda_device)
    lengths = torch.tensor([5, 40], dtype=torch.int32, device=cuda_device)
    q.requires_grad_()
    n0 = ops.paged_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(q, kp, vp, tables, lengths)
    assert ops.paged_attention.launches == n0
    with torch.no_grad():
        ops.paged_attention(q, kp, vp, tables, lengths)
    assert ops.paged_attention.launches == n0 + 1
