"""The port's MoE MLP (scatter dispatch) against the reference on
qwen3-moe-30b-a3b's smoke config: `moe_forward` alone at three capacity
factors (the smallest drops tokens), the model's prefill and ring-cache
decode, and the engine's paged path — prefill, 8 decode steps through
`Instance` (plain paged attention on the CPU) and fused `decode_many` —
with identical block tables and load ledgers.

Inputs come from numpy with a seed; reference weights cross by leaf name.
Tolerances are tests/test_kernels.py's: 2e-5 absolute for fp32, 2e-2 of
the reference's scale for bf16.

Routing ties.  `torch.topk` and `jax.lax.top_k` may order equal
probabilities differently, so the direct tests assert that no row of router
probabilities holds a tie.  Through a whole bf16 model the two frameworks
round the hidden state at different points, so the router's inputs differ
by a few bf16 steps and a token whose k-th and (k+1)-th expert
probabilities nearly tie may be routed either way: a tie at bf16's
precision, where both answers are right and the logits differ by far more
than 2e-2.  The model tests therefore give the port the reference's expert
choices (`RouterReplay`: each reference top-k is recorded, and the port's
`moe_forward` takes it in place of its own, weighted by its own router
probabilities) and then hold every row, in fp32 and bf16, drops included.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import (close_to, load_ledger, load_report,  # noqa: E402
                                max_err, paired_engines, ref_named_numpy,
                                to_torch)

NAME = "qwen3-moe-30b-a3b"


class RouterReplay:
    """Records the expert ids of every top-k of the reference's
    `moe_forward` (one per MoE layer and forward, in call order, through an
    ordered debug callback) and makes each call of the port's
    `moe_forward` route by the next of them.  `dropped` says whether some
    replayed routing overflowed an expert's capacity."""

    def __init__(self, monkeypatch):
        self.ids = []
        self.dropped = False
        real_top_k, real_topk = jax.lax.top_k, torch.topk
        inner = port_layers.moe_forward

        def recording(x, k):
            w, idx = real_top_k(x, k)
            jax.debug.callback(lambda i: self.ids.append(np.asarray(i)), idx,
                               ordered=True)
            return w, idx

        def replaying(p, x, cfg, cf):
            jax.effects_barrier()  # the reference's callbacks have run
            assert self.ids, "the port ran an MoE layer the reference did not"
            ids = torch.from_numpy(self.ids.pop(0).astype(np.int64))
            T, k = ids.shape
            assert T == x.shape[0] * x.shape[1], (ids.shape, x.shape)
            counts = np.bincount(ids.reshape(-1).numpy(), minlength=cfg.num_experts)
            self.dropped |= bool(counts.max() > port_layers.moe_capacity(
                T, k, cfg.num_experts, cf))

            def topk(probs, kk, dim=-1, **kw):
                assert kk == k and probs.shape[0] == T and dim == -1
                return probs.gather(dim, ids), ids

            torch.topk = topk
            try:
                return inner(p, x, cfg, cf)
            finally:
                torch.topk = real_topk

        jax.clear_caches()  # no compiled reference step may skip the callback
        monkeypatch.setattr(jax.lax, "top_k", recording)
        monkeypatch.setattr(port_layers, "moe_forward", replaying)

    def done(self):
        jax.effects_barrier()
        assert not self.ids, f"{len(self.ids)} reference MoE calls not replayed"


@pytest.fixture
def router_replay(monkeypatch):
    replay = RouterReplay(monkeypatch)
    yield replay
    jax.clear_caches()  # drop the traces that call back into this recorder


def pair(dtype, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(ref_config(NAME).smoke(), **over),
            dataclasses.replace(port_config(NAME).smoke(), **over))


def routing(x, router, cfg):
    """Top-k expert ids of each token (numpy, fp32 router), and whether a
    row of probabilities holds a tie."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float32) @ np.asarray(router)
    ties = any(len(np.unique(row)) < row.size for row in logits)
    return np.argsort(-logits, axis=-1)[:, : cfg.experts_per_token], ties


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_reference(dtype, cf):
    rc, pc = pair(dtype)
    p = ref_layers.init_moe(jax.random.PRNGKey(11), rc)
    pp = {k: to_torch(v) for k, v in p.items()}
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 16, rc.d_model))
                    .astype(np.float32)).astype(rc.jnp_dtype)
    ids, ties = routing(np.asarray(x.astype(jnp.float32)), p["router"], rc)
    assert not ties
    T, k, E = 32, rc.experts_per_token, rc.num_experts
    cap = port_layers.moe_capacity(T, k, E, cf)
    dropped = sum(max(0, int((ids == e).sum()) - cap) for e in range(E))
    # cf 0.25 puts the capacity at its floor of 8 slots and drops pairs;
    # 4.0 and 1.25 keep every pair at this size
    assert (dropped > 0) == (cf == 0.25), (cf, cap, dropped)

    ref = jax.jit(lambda p, x: ref_layers.moe_forward(p, x, rc, cf))(p, x)
    out = port_layers.moe_forward(pp, to_torch(x), pc, cf)
    assert out.dtype == pc.torch_dtype and tuple(out.shape) == tuple(ref.shape)
    assert close_to(out, ref, dtype), max_err(out, ref)


# The routed path against the slot path and the reference: (case, dtype).
# T tokens of the smoke config (E 8, k 2) just below, at and above T * k =
# E; 12 identical tokens at E 128, k 8 (capacity 8 at decode: 4 of each
# routed expert's 12 pairs dropped); then inputs the rule keeps on the slot
# path although T * k < E: a DTensor, a slice of the experts, and an input
# that autograd records.
ROUTED_CASES = [(case, dt) for case in ("below", "at", "above", "drops")
                for dt in ("float32", "bfloat16")] + [
                   ("dtensor", "float32"), ("slice", "float32"), ("grad", "float32")]

DTENSOR_SNIPPET = """
import dataclasses, tempfile, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers
dist.init_process_group("gloo", init_method="file://" + tempfile.mktemp(), rank=0, world_size=1)
try:
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(), dtype="float32")
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((1, 3, cfg.d_model), generator=torch.Generator().manual_seed(1))
    calls, real = [], ops.moe_experts
    ops.moe_experts = lambda *a: calls.append(1) or real(*a)
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    dp = {n: distribute_tensor(t, mesh, [Replicate() if n == "router" else Shard(0)])
          for n, t in p.items()}
    y = layers.moe_forward(dp, distribute_tensor(x, mesh, [Replicate()]), cfg, 4.0).full_tensor()
    print(len(calls), torch.equal(y, layers._moe_slots(p, x, cfg, 4.0)))
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("case, dtype", ROUTED_CASES, ids=[f"{c}-{d}" for c, d in ROUTED_CASES])
def test_routed_path_matches_slot_path_and_reference(case, dtype, monkeypatch):
    """`moe_forward` takes the routed experts (`kernels.ops.moe_experts`, its
    plain version on the CPU) exactly where T * k < E, x is no DTensor, the
    weights hold every expert and autograd records nothing; either way it
    equals the slot path and the reference's `moe_forward` (decode capacity
    factor 4.0), dropped pairs included."""
    if case == "dtensor":  # a process group lives in a subprocess of its own
        from dist_helpers import run_snippet

        out = run_snippet(DTENSOR_SNIPPET)
        assert out.returncode == 0, out.stderr[-4000:]
        assert out.stdout.split() == ["0", "True"], out.stdout
        return
    from repro_torch.kernels import ops

    wide = dict(num_experts=128, experts_per_token=8) if case == "drops" else {}
    rc, pc = pair(dtype, **wide)
    p = ref_layers.init_moe(jax.random.PRNGKey(7), rc)
    pp = {k: to_torch(v) for k, v in p.items()}
    T = {"below": 3, "at": 4, "above": 5}.get(case, 12)
    rows = 1 if case == "drops" else T  # drops: 12 copies of one token
    x = np.random.default_rng(8).standard_normal((1, rows, rc.d_model)).astype(np.float32)
    x = jnp.asarray(np.repeat(x, T // rows, axis=1)).astype(rc.jnp_dtype)
    ids, ties = routing(np.asarray(x.astype(jnp.float32)), p["router"], rc)
    assert not ties
    E, k, cf = rc.num_experts, rc.experts_per_token, port_layers.DECODE_CAPACITY_FACTOR
    cap = port_layers.moe_capacity(T, k, E, cf)
    dropped = sum(max(0, int((ids == e).sum()) - cap) for e in range(E))
    assert dropped == (4 * k if case == "drops" else 0), (cap, dropped)

    calls = []
    monkeypatch.setattr(ops, "moe_experts",
                        lambda *a, _f=ops.moe_experts: calls.append(1) or _f(*a))
    xt, first = to_torch(x), 0
    if case == "slice":  # experts [2, 6) of 8, as one rank of expert parallelism holds them
        first = 2
        pp = {n: t if n == "router" else t[first:first + 4] for n, t in pp.items()}
    if case == "grad":
        xt.requires_grad_(True)
    out = port_layers.moe_forward(pp, xt, pc, cf, first_expert=first)
    routed = case in ("below", "drops")
    assert calls == [1] * routed, (case, calls)
    with torch.no_grad():
        slots = port_layers._moe_slots(pp, xt, pc, cf, first)
    assert out.dtype == pc.torch_dtype and out.shape == slots.shape
    if not routed:
        assert torch.equal(out.detach(), slots)
    assert close_to(out.detach(), slots, dtype), max_err(out.detach(), slots)
    if case in ("slice", "grad"):
        return
    ref = jax.jit(lambda p, x: ref_layers.moe_forward(p, x, rc, cf))(p, x)
    assert close_to(out, ref, dtype), max_err(out, ref)


@pytest.mark.parametrize("experts,shape", [(8, (6,)), (128, (8,)), (128, (64,)), (64, (3000,)),
                                           (64, (2, 40)), (8, (3, 5))])
def test_slot_layouts_count_alike(experts, shape):
    """`_slots`' two one-hot layouts give the same running counts, and
    slots and drops are the running counts capped, whichever it takes."""
    flat_e = torch.randint(0, experts, shape, generator=torch.Generator().manual_seed(experts))
    outer = port_layers._running_counts(flat_e, experts, inner=False)
    assert torch.equal(outer, port_layers._running_counts(flat_e, experts, inner=True))
    earlier = (flat_e[..., None, :] == flat_e[..., :, None]).tril().sum(-1) - 1
    assert torch.equal(outer, earlier)
    slot, keep = port_layers._slots(flat_e, experts, cap=2)
    assert torch.equal(keep, earlier < 2) and torch.equal(slot, earlier.clamp(max=2))


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_moe_capacity_factors_follow_the_reference(step, monkeypatch):
    """Prefill routes with capacity factor 1.25 and every decode step (ring
    and paged) with 4.0, as the reference's `lm.forward`, `lm.decode_step`
    and paged decode step do."""
    _, pc = pair("float32", num_layers=2)
    model = port_build(pc)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []
    inner = port_layers.moe_forward
    monkeypatch.setattr(port_layers, "moe_forward",
                        lambda p, x, cfg, cf: seen.append(cf) or inner(p, x, cfg, cf))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, cache_cap=8)
    if step == "decode":
        seen.clear()
        model.decode(params, toks[:, 0], torch.full((1,), 4, dtype=torch.int32), cache)
    want = (port_layers.PREFILL_CAPACITY_FACTOR if step == "prefill"
            else port_layers.DECODE_CAPACITY_FACTOR)
    assert seen == [want] * 2
    assert want == {"prefill": 1.25, "decode": 4.0}[step]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_and_ring_decode_match_reference(dtype, router_replay):
    """Model.prefill (capacity factor 1.25) and 8 Model.decode steps (4.0)
    with the reference's expert choices: every row within tolerance."""
    rc, pc = pair(dtype, num_layers=2)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(5))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B, S, cap = 2, 24, 40
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: rm.prefill(p, b, cache_cap=cap))(
        rp, {"tokens": jnp.asarray(toks)})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_cap=cap)
    assert close_to(pl, rl, dtype), max_err(pl, rl)
    assert router_replay.dropped  # capacity 16 for 96 (token, choice) pairs: some drop
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    ref_decode = jax.jit(rm.decode)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close_to(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    router_replay.done()


def _engine_pair(dtype):
    rc, pc = pair(dtype, num_layers=2)
    ref, port, _ = paired_engines({"m": (rc, pc, 3)})
    assert load_report(port.load("m")) == load_report(ref.load("m"))
    assert load_ledger(port) == load_ledger(ref)
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_engine_prefill_and_paged_decode_match_reference(dtype, router_replay):
    """Mixed-length prefill, then 8 paged decode steps that cross a block
    boundary, with the reference's expert choices: logits within
    tolerance, identical tables and uploads."""
    ref, port = _engine_pair(dtype)
    ri = ref.start_instance("m", num_pages=64, attn_mode="ref")
    pi = port.start_instance("m", num_pages=64)
    lens = [12, 9]
    toks = np.random.default_rng(3).integers(0, 512, (2, 12)).astype(np.int32)
    rl = ri.prefill({"tokens": jnp.asarray(toks)}, lengths=lens)
    pl = pi.prefill({"tokens": torch.from_numpy(toks)}, lengths=lens)
    assert close_to(pl, rl, dtype), max_err(pl, rl)
    assert router_replay.dropped  # capacity 8 for 48 (token, choice) pairs: some drop
    assert np.array_equal(pi._tables_np, ri._tables_np)
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    for step in range(8):
        rl = ri.decode(jnp.asarray(tok))
        pl = pi.decode(torch.from_numpy(tok))
        assert close_to(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        assert np.array_equal(pi._tables_np, ri._tables_np), step
        assert pi.table_uploads == ri.table_uploads
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    router_replay.done()
    assert pi.table_uploads == 2  # each row crossed into its second block
    ri.finish(), pi.finish()
    assert port.store.free_bytes() == ref.store.free_bytes()
    ref.close(), port.close()


def test_moe_decode_many_matches_reference():
    """Two same-model instances fused into one dispatch per step (B 3):
    logits within tolerance of the reference's fused step."""
    ref, port = _engine_pair("float32")
    rng = np.random.default_rng(4)
    pairs = []
    for B in (1, 2):
        toks = rng.integers(0, 512, (B, 10)).astype(np.int32)
        ri = ref.start_instance("m", num_pages=64, attn_mode="ref")
        pi = port.start_instance("m", num_pages=64)
        rl = ri.prefill({"tokens": jnp.asarray(toks)})
        pl = pi.prefill({"tokens": torch.from_numpy(toks)})
        assert close_to(pl, rl, "float32")
        pairs.append((ri, pi, np.asarray(jnp.argmax(rl, -1)).astype(np.int32)))
    for step in range(8):
        routs = ref.decode_many([(ri, jnp.asarray(t)) for ri, _, t in pairs])
        pouts = port.decode_many([(pi, torch.from_numpy(t)) for _, pi, t in pairs])
        for (ri, pi, _), rl, pl in zip(pairs, routs, pouts):
            assert close_to(pl, rl, "float32"), f"step {step}: {max_err(pl, rl)}"
            assert np.array_equal(pi._tables_np, ri._tables_np)
        pairs = [(ri, pi, np.asarray(jnp.argmax(rl, -1)).astype(np.int32))
                 for (ri, pi, _), rl in zip(pairs, routs)]
    for ri, pi, _ in pairs:
        ri.finish(), pi.finish()
    ref.close(), port.close()
