"""The port's two kernels: their plain PyTorch versions against the reference
oracles (and, at one tiny shape each, the Pallas kernels in interpret mode),
and the wrappers' CPU dispatch.  The CUDA kernels are held against the plain
versions on the card by test_torch_kernels_card.py.

Inputs are drawn with numpy from a seed, rounded to the working dtype once
on the JAX side, and handed bit-identically to both packages.  Tolerances
are tests/test_kernels.py's: 2e-5 in fp32 (sums in another order), 2e-2 in
bf16 (the frameworks round the probabilities and the P.V product at other
places).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models.common import attention_dense as ref_attention_dense  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import check_cuda_inputs  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref  # noqa: E402

from torch_port_helpers import TOL, max_err, to_torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "reference_kernel_tests", Path(__file__).resolve().parents[1] / "test_kernels.py")
_ref_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref_tests)
PAGED_CASES = _ref_tests.PAGED_CASES  # (B, H, K, hd, T, P, N)
FLASH_CASES = _ref_tests.FLASH_CASES  # (B, S, H, K, hd, causal, window, bq, bk)
DTYPES = ["float32", "bfloat16"]
# beyond the reference's cases: a page count and table width no case has, and
# sequence lengths that are no multiple of the CUDA kernel's 64-row tiles
PORT_PAGED_CASES = [(3, 8, 2, 64, 16, 40, 9)]
PORT_FLASH_CASES = [(2, 130, 4, 2, 64, True, 0, 0, 0),
                    (1, 77, 4, 4, 32, True, 30, 0, 0),
                    (1, 100, 2, 1, 64, False, 0, 0, 0)]


def jarr(rng, shape, dtype):
    """Standard-normal draw rounded to `dtype` on the JAX side."""
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(dtype)


def paged_inputs(seed, B, H, K, hd, T, P, N, dtype):
    rng = np.random.default_rng(seed)
    q = jarr(rng, (B, H, hd), dtype)
    kp = jarr(rng, (P, T, K, hd), dtype)
    vp = jarr(rng, (P, T, K, hd), dtype)
    tables = jnp.asarray(rng.integers(0, P, (B, N)).astype(np.int32))
    lengths = jnp.asarray(rng.integers(1, N * T + 1, (B,)).astype(np.int32))
    return (q, kp, vp, tables, lengths), tuple(to_torch(a) for a in (q, kp, vp, tables, lengths))


def flash_inputs(seed, B, S, H, K, hd, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = jarr(rng, (B, S, H, hd), dtype), jarr(rng, (B, S, K, hd), dtype), \
        jarr(rng, (B, S, K, hd), dtype)
    return (q, k, v), tuple(to_torch(a) for a in (q, k, v))


# ------------------------------------------------------------ paged attention
@pytest.mark.parametrize("case", PAGED_CASES + PORT_PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_matches_reference_oracle(case, dtype):
    (jx, tx) = paged_inputs(sum(case), *case, dtype)
    ref = ref_ops.paged_attention_ref(*jx)
    out = paged_attention_ref(*tx)
    assert out.dtype == tx[0].dtype and tuple(out.shape) == tuple(ref.shape)
    assert max_err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_matches_pallas_kernel_interpret(dtype):
    jx, tx = paged_inputs(5, 2, 4, 2, 64, 16, 8, 3, dtype)
    pallas = ref_ops.paged_attention(*jx, mode="interpret")
    assert max_err(ops.paged_attention(*tx), pallas) < TOL[dtype]


def test_paged_single_token_context():
    """length=1: exactly one KV slot contributes."""
    rng = np.random.default_rng(1)
    q = torch.ones((1, 2, 64))
    kp = torch.from_numpy(rng.standard_normal((4, 16, 2, 64)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((4, 16, 2, 64)).astype(np.float32))
    out = ops.paged_attention(q, kp, vp, torch.tensor([[2, 0]], dtype=torch.int32),
                              torch.tensor([1], dtype=torch.int32))
    assert torch.allclose(out[0], vp[2, 0], atol=1e-5)


def test_paged_ignores_stale_pages():
    """Entries past `length` (and their page ids) must not affect output."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((8, 16, 2, 64)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((8, 16, 2, 64)).astype(np.float32))
    t1 = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    t2 = torch.tensor([[0, 1, 7], [3, 4, 6]], dtype=torch.int32)
    lengths = torch.tensor([20, 30], dtype=torch.int32)
    o1 = ops.paged_attention(q, kp, vp, t1, lengths)
    o2 = ops.paged_attention(q, kp, vp, t2, lengths)
    assert torch.allclose(o1, o2, atol=1e-6)


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("case", FLASH_CASES + PORT_FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_reference_oracle(case, dtype):
    B, S, H, K, hd, causal, window, _bq, _bk = case
    jx, tx = flash_inputs(sum(case[:5]), B, S, H, K, hd, dtype)
    ref = ref_ops.flash_attention_ref(*jx, causal=causal, window=window)
    out = flash_attention_ref(*tx, causal=causal, window=window)
    assert max_err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_pallas_kernel_interpret(dtype):
    jx, tx = flash_inputs(6, 1, 64, 4, 2, 32, dtype)
    pallas = ref_ops.flash_attention(*jx, causal=True, window=24, block_q=32,
                                     block_k=32, mode="interpret")
    out = ops.flash_attention(*tx, causal=True, window=24)
    assert max_err(out, pallas) < TOL[dtype]


@pytest.mark.parametrize("S,window", [(100, 0), (77, 30), (130, 64)])
def test_flash_tail_matches_reference_dense_attention(S, window):
    """S that is no block multiple (the TPU kernel refuses it) against the
    reference model's dense attention."""
    jx, tx = flash_inputs(S, 2, S, 4, 2, 64, jnp.float32)
    ref = ref_attention_dense(*jx, causal=True, window=window)
    out = ops.flash_attention(*tx, causal=True, window=window)
    assert max_err(out, ref) < TOL["float32"]


def test_flash_matches_port_model_attention():
    """The prefill kernel's plain version agrees with the port's own dense
    attention (the reference's test_flash_matches_model_attention)."""
    from repro_torch.models.common import attention_chunked, attention_dense

    _, (q, k, v) = flash_inputs(9, 2, 128, 4, 2, 64, jnp.float32)
    out = ops.flash_attention(q, k, v, causal=True, window=48)
    assert max_err(out, attention_dense(q, k, v, causal=True, window=48)) < 2e-5
    assert max_err(out, attention_chunked(q, k, v, causal=True, window=48,
                                          q_chunk=32, kv_chunk=64)) < 2e-5


# ------------------------------------------------------------------ wrappers
def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    _, tx = paged_inputs(3, *PAGED_CASES[1], "float32")
    assert torch.equal(ops.paged_attention(*tx), paged_attention_ref(*tx))
    _, fx = flash_inputs(4, 1, 64, 4, 2, 64, jnp.float32)
    assert torch.equal(ops.flash_attention(*fx), flash_attention_ref(*fx))
    assert ops.launch_counts() == {"paged_attention": 0, "flash_attention": 0}


def test_wrapper_input_checks_reject_what_the_kernel_cannot_take():
    a = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        check_cuda_inputs({"q": a}, {"q": (torch.bfloat16,)})
    with pytest.raises(ValueError, match="contiguous"):
        check_cuda_inputs({"q": a.t()}, {"q": (torch.float32,)})
    with pytest.raises(ValueError, match="aligned"):
        check_cuda_inputs({"q": a.reshape(-1)[1:]}, {"q": (torch.float32,)})
    check_cuda_inputs({"q": a, "t": torch.zeros(3, dtype=torch.int32)},
                      {"q": (torch.float32,), "t": (torch.int32,)})

