"""The paged decode step's residual add and RMSNorm (`kernels/add_rms_norm.py`)
on the CPU, where the wrapper runs its plain version.

The plain version is held, to the bit, against the chain the step ran
before the kernel existed: `h + delta`, then `common.rms_norm` of the sum,
at every served width (D 2048, 3584, 4096), at B 1 and 3, with and without
`delta`.  The wrapper's checks (dtype, shape, contiguity, width, autograd)
hold on every device.  The engine's paged decode logits against the step
as it was are in `test_torch_rope_kv_write.py -k engine_paged`, and the
launches a step in `test_torch_step_graph.py`.
"""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import add_rms_norm_ref  # noqa: E402
from repro_torch.models import common  # noqa: E402


def norm_inputs(B, D, seed=0, dtype=torch.bfloat16):
    """A residual stream, a sub-block's output of a smaller scale and a
    norm's scale, as a served layer holds them."""
    g = torch.Generator().manual_seed(seed)
    h = (torch.randn((B, 1, D), generator=g) * 4).to(dtype)
    delta = (torch.randn((B, 1, D), generator=g) * 0.5).to(dtype)
    scale = torch.randn((D,), generator=g) * 0.1
    return h, delta, scale


@pytest.mark.parametrize("with_delta", [True, False], ids=["add", "norm-only"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("D", [2048, 3584, 4096])
def test_plain_version_equals_the_chain_bitwise(D, B, with_delta):
    h, delta, scale = norm_inputs(B, D, seed=D + B)
    delta = delta if with_delta else None
    want_h = h + delta if with_delta else h
    want_x = common.rms_norm(want_h, scale, 1e-6)
    for fn in (add_rms_norm_ref, ops.add_rms_norm):
        got_h, got_x = fn(h, delta, scale, 1e-6)
        assert torch.equal(got_h, want_h) and torch.equal(got_x, want_x)
        assert got_x.dtype == torch.bfloat16 and got_x.shape == h.shape
    if not with_delta:
        assert ops.add_rms_norm(h, None, scale, 1e-6)[0] is h  # norm only: h passes through


def test_plain_version_takes_float32_as_the_chain_does():
    h, delta, scale = norm_inputs(2, 256, dtype=torch.float32)
    got = ops.add_rms_norm(h, delta, scale, 1e-5)
    assert torch.equal(got[0], h + delta)
    assert torch.equal(got[1], common.rms_norm(h + delta, scale, 1e-5))


def test_wrapper_rejects_what_the_kernel_cannot_take():
    h, delta, scale = norm_inputs(2, 256)
    bad_shape = {"h 2-d": (h[:, 0], delta[:, 0], scale),
                 "delta width": (h, delta[..., :128], scale),
                 "delta batch": (h, delta[:1], scale),
                 "scale width": (h, delta, scale[:128])}
    for what, args in bad_shape.items():
        with pytest.raises(ValueError, match="shape mismatch"):
            ops.add_rms_norm(*args, 1e-6)
            pytest.fail(f"took {what}")
    h12, d12, s12 = norm_inputs(2, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.add_rms_norm(h12, d12, s12, 1e-6)
    hw, dw, sw = norm_inputs(1, 8200)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.add_rms_norm(hw, dw, sw, 1e-6)
    with pytest.raises(TypeError, match="delta"):
        ops.add_rms_norm(h, delta.float(), scale, 1e-6)
    with pytest.raises(TypeError, match="scale"):
        ops.add_rms_norm(h, delta, scale.to(torch.bfloat16), 1e-6)
    strided = torch.cat([h, h], dim=-1)[..., :256]
    with pytest.raises(ValueError, match="h must be contiguous"):
        ops.add_rms_norm(strided, delta, scale, 1e-6)
    with pytest.raises(ValueError, match="delta must be contiguous"):
        ops.add_rms_norm(h, strided, scale, 1e-6)
    with pytest.raises(ValueError, match="scale must be contiguous"):
        ops.add_rms_norm(h, delta, torch.cat([scale, scale])[::2], 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.add_rms_norm(h, delta.clone().requires_grad_(True), scale, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.add_rms_norm(h, None, scale.clone().requires_grad_(True), 1e-6)
    with torch.no_grad():  # nothing records: the plain version runs
        ops.add_rms_norm(h, delta.clone().requires_grad_(True), scale, 1e-6)


def test_cpu_calls_launch_nothing():
    n0 = ops.add_rms_norm.launches
    ops.add_rms_norm(*norm_inputs(1, 2048), 1e-6)
    assert ops.add_rms_norm.launches == n0
    assert "add_rms_norm" in ops.launch_counts()
