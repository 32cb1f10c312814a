"""The paged decode step's residual add and RMSNorm kernel
(`kernels/add_rms_norm.py`, CUDA `csrc/add_rms_norm.cu`) on the card.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port/test_torch_add_rms_norm_card.py

- The kernel against the chain it replaced (`ref.add_rms_norm_ref`: the
  add, then `common.rms_norm`) at every served width (D 2048, 3584, 4096),
  at B 1 and 4, with and without the add: h + delta equal to the bit; the
  norm within one bfloat16 step an element, and at most `SHARE` of its
  elements off.  The kernel sums the squares over D in another order than
  PyTorch's reduction, which moves the float32 sum, and so the norm's
  factor, by a rounding step now and then; nothing else differs.
- The wrapper raises on float32, a non-contiguous operand, a CPU operand
  beside CUDA ones and under autograd, and launches nothing then.
- An `Engine` over deepseek-7b, qwen3-moe-30b-a3b at 12 of its 48 layers
  and DeepSeek-V2-Lite, full width: a served batch of three prompts fed
  the same tokens, decoded through the kernel's step eagerly, against the
  step over the plain chain (`ops.add_rms_norm` replaced by its plain
  version) routed to the kernel step's experts: logits within `TOL` of
  their scale, and any changed greedy token a tie within it.  The graphed
  step equals the eager one to the bit, and every step, replays included,
  counts 2 L + 1 launches.
"""
import contextlib
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.add_rms_norm import add_rms_norm  # noqa: E402
from repro_torch.kernels.ref import add_rms_norm_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

EPS = 1e-6
SHARE = 1e-3  # of the norm's elements one bfloat16 step off the chain's
TOL = 2e-2  # bf16 logits, relative to their scale (tests/test_kernels.py)


def bf16_steps(a, b):
    """Bfloat16 steps between `a` and `b`, element by element."""
    def key(t):  # the bit patterns, ordered as the values are
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (key(a) - key(b)).abs()


def norm_inputs(B, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (torch.randn((B, 1, D), generator=g, device="cuda") * 4).to(torch.bfloat16)
    delta = (torch.randn((B, 1, D), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    scale = torch.randn((D,), generator=g, device="cuda") * 0.1
    return h, delta, scale


@pytest.mark.parametrize("with_delta", [True, False], ids=["add", "norm-only"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("D", [2048, 3584, 4096])
def test_kernel_against_the_chain(cuda_device, D, B, with_delta):
    h, delta, scale = norm_inputs(B, D, seed=D + B)
    delta = delta if with_delta else None
    want_h, want_x = add_rms_norm_ref(h, delta, scale, EPS)
    n0 = ops.add_rms_norm.launches
    got_h, got_x = ops.add_rms_norm(h, delta, scale, EPS)
    torch.cuda.synchronize()
    assert ops.add_rms_norm.launches == n0 + 1
    assert torch.equal(got_h, want_h)
    assert (got_h is h) == (delta is None)
    steps = bf16_steps(got_x, want_x)
    assert int(steps.max()) <= 1
    assert float((steps > 0).float().mean()) <= SHARE
    # and the inputs are left as they were
    again = norm_inputs(B, D, seed=D + B)
    assert torch.equal(h, again[0]) and torch.equal(scale, again[2])


def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda_device):
    h, delta, scale = norm_inputs(1, 4096)
    n0 = ops.add_rms_norm.launches
    with pytest.raises(TypeError, match="h has dtype"):
        ops.add_rms_norm(h.float(), delta.float(), scale, EPS)
    with pytest.raises(TypeError, match="delta"):
        ops.add_rms_norm(h, delta.float(), scale, EPS)
    h2, d2, _ = norm_inputs(2, 4096)  # at B 1 a column slice is still contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rms_norm(torch.cat([h2, h2], -1)[..., :4096], d2, scale, EPS)
    with pytest.raises(ValueError, match="on cpu"):
        ops.add_rms_norm(h, delta, scale.cpu(), EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.add_rms_norm(h[..., :4092].contiguous(), delta[..., :4092].contiguous(),
                         scale[:4092], EPS)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.add_rms_norm(h.clone().requires_grad_(True), delta, scale, EPS)
    assert ops.add_rms_norm.launches == n0


# (arch, layers): full width; qwen3-moe at the benchmark's 12 of 48 layers
SERVED = {"deepseek-7b": None, "qwen3-moe-30b-a3b": 12, "deepseek-v2-lite": None}
STEPS = 8


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def release_memory():
    """Free what earlier runs left: their engines, the device blocks PyTorch
    caches, and the page-locked host blocks it caches (a model's weights)."""
    gc.collect()
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()


def host_weights(cfg):
    """The model's weights drawn on the card, kept page-locked on the host
    (so every engine loads the same tensors and the card holds one copy)."""
    release_memory()
    tree = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t),
                    tree)
    del tree
    torch.cuda.empty_cache()
    return host


@contextlib.contextmanager
def expert_choices(record=None, replay=None):
    """Record every MoE layer's expert choices (`torch.topk` in
    `moe_forward`) into `record`, or take them from `replay` in call order.
    In bfloat16 a token whose k-th and (k+1)-th experts nearly tie is routed
    either way by two steps that round differently, and a norm one bfloat16
    step off is such a difference: the comparison holds the routing fixed."""
    real = torch.topk
    calls = iter(replay) if replay is not None else None

    def topk(x, k, dim=-1, **kw):
        if calls is not None:
            idx = next(calls).reshape(*x.shape[:-1], k)
            return x.gather(dim, idx), idx
        out = real(x, k, dim=dim, **kw)
        record.append(out.indices.clone())
        return out

    torch.topk = topk
    try:
        yield
    finally:
        torch.topk = real


def served_run(cfg, tree, graphed, chain, monkeypatch, route=contextlib.nullcontext()):
    """A B 3 batch of prompts 600 / 333 / 47 decoded STEPS steps fed the
    same tokens, under `route`; the logits, each step's launches of the
    kernel and the step graphs' (eager, captures, replays)."""
    if chain:
        monkeypatch.setattr(ops, "add_rms_norm", add_rms_norm_ref)
    eng = Engine(40 << 30, cuda_graphs=graphed, engine_id=f"{graphed}-{chain}")
    try:  # a failed run frees the card for the next test
        eng.register(cfg.name, cfg, init_fn=lambda: tree)
        eng.load(cfg.name)
        batch = build_model(cfg).make_batch(torch.Generator().manual_seed(5),
                                            ShapeConfig("card", 600, 3, "prefill"), device="cuda")
        inst = eng.start_instance(cfg.name)
        gen = torch.Generator().manual_seed(6)
        per_step = []
        with route:
            logits = [inst.prefill(batch, lengths=(600, 333, 47))]
            for _ in range(STEPS):
                tok = torch.randint(0, cfg.vocab_size, (3,), generator=gen,
                                    dtype=torch.int32).cuda()
                before = add_rms_norm.launches
                logits.append(inst.decode(tok))
                per_step.append(add_rms_norm.launches - before)
        torch.cuda.synchronize()
        counts = None if eng.step_graphs is None else (
            eng.step_graphs.eager_steps, eng.step_graphs.captures, eng.step_graphs.replays)
        inst.finish()
        return [t.cpu() for t in logits], per_step, counts
    finally:
        eng.close()
        if chain:
            monkeypatch.undo()
        gc.collect()


@pytest.mark.parametrize("arch", SERVED)
def test_served_batch_against_the_chain_2l_plus_1_launches(cuda_device, arch, monkeypatch):
    """The kernel's step eager (its expert choices recorded), the chain's
    step eager (routed as the kernel's), then the kernel's step graphed."""
    cfg = get_config(arch)
    if SERVED[arch]:
        cfg = dataclasses.replace(cfg, num_layers=SERVED[arch])
    tree = host_weights(cfg)
    choices = []
    eager, eager_steps, _ = served_run(cfg, tree, False, False, monkeypatch,
                                       expert_choices(record=choices))
    want, chain_steps, _ = served_run(cfg, tree, False, True, monkeypatch,
                                      expert_choices(replay=choices))
    got, steps, counts = served_run(cfg, tree, True, False, monkeypatch)
    del tree
    release_memory()
    assert bool(choices) == cfg.is_moe
    assert chain_steps == [0] * STEPS
    assert counts == (1, 1, STEPS - 1)
    assert steps == eager_steps == [2 * cfg.num_layers + 1] * STEPS
    for i, (g, e) in enumerate(zip(got, eager)):  # the same kernels, replayed
        assert torch.equal(g, e), i
    assert torch.equal(eager[0], want[0])  # the prefill does not run the kernel
    for i, (e, w) in enumerate(zip(eager[1:], want[1:])):
        e, w = e.float(), w.float()
        scale = max(1.0, float(w.abs().max()))
        assert float((e - w).abs().max()) <= TOL * scale, i
        et, wt = e.argmax(-1), w.argmax(-1)
        for row in torch.nonzero(et != wt).flatten().tolist():
            assert float(w[row, wt[row]] - w[row, et[row]]) <= TOL * scale, (i, row)
