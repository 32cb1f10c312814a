"""The compiled paged decode step (`serving/step_graph.py`) on the CPU.

A CPU engine never captures, so these tests inject `RecordingCapture`, a
double of `CudaGraphCapture`: its capture runs the eager step once (as a
real capture runs the step's Python, whose wrappers count launches that
only a replay makes), and its replay reruns the step into the static
outputs without counting (a real replay runs no Python).  Held against an
eager engine over the same calls: the key policy (first call eager, second
captures, later calls replay, instances of a model share a key), every
site that must drop a graph, fresh outputs, launch counts, and the number
of specialisations against the reference's ``jax.jit`` cache of
`_paged_decode_step`.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.tensors import VariantSpec  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.step_graph import StepGraphs  # noqa: E402

from torch_port_helpers import RecordingCapture  # noqa: E402


def cfg(layers=2, **over):
    return dataclasses.replace(port_config("llama3.2-1b").smoke(), num_layers=layers,
                               vocab_size=512, dtype="float32", **over)


def engine(graphed: bool, cap=256 << 20, models=(("m", 2),), **kw) -> Engine:
    eng = Engine(cap, device="cpu", **kw)
    for mid, layers in models:
        eng.register(mid, cfg(layers))
    if graphed:
        eng.step_graphs = StepGraphs(RecordingCapture())
    return eng


def prompt(B=2, S=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, 512, (B, S), generator=gen, dtype=torch.int32)}


def started(eng, mid="m", seed=0, num_pages=64, B=2):
    inst = eng.start_instance(mid, num_pages=num_pages)
    return inst, inst.prefill(prompt(B, seed=seed)).argmax(-1).to(torch.int32)


def greedy(logits):
    return logits.argmax(-1).to(torch.int32)


@pytest.fixture
def counted_k1(monkeypatch):
    """K1's, the rope + K/V write's and the add + RMSNorm's CPU paths
    counted as the CUDA wrappers count a launch."""
    for name in ("paged_attention", "rope_kv_write", "add_rms_norm"):
        real = getattr(ops, name)

        def counted(*args, _real=real):
            _real.launches += 1
            return _real(*args)

        monkeypatch.setattr(ops, name, counted)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def test_cpu_engine_never_captures():
    assert Engine(1 << 20, device="cpu").step_graphs is None
    assert Engine(1 << 20, device="cpu", cuda_graphs=True).step_graphs is None


def test_first_call_eager_second_captures_then_replays_shared_by_instances():
    outs = {}
    for graphed in (False, True):
        eng = engine(graphed)
        eng.load("m")
        a, ta = started(eng, seed=1)
        b, tb = started(eng, seed=2)
        steps = []
        for i in range(6):
            la = a.decode(ta)
            if graphed:
                g = eng.step_graphs
                # the key's first call (a's) runs eagerly, its second (b's)
                # captures and replays, and every later call replays
                assert (g.eager_steps, g.captures, g.replays) == (1, min(i, 1), 2 * i), i
            lb = b.decode(tb)  # the second instance shares a's key
            steps.append((la, lb))
            ta, tb = greedy(la), greedy(lb)
        if graphed:
            assert (g.eager_steps, g.captures, len(g)) == (1, 1, 1)
            assert g.replays == 11 and g.capture.replayed == 11
            assert len(g.live("m")) == 1
        outs[graphed] = steps
        a.finish(), b.finish()
        eng.close()
    for (ea, eb), (ga, gb) in zip(outs[False], outs[True]):
        assert torch.equal(ea, ga) and torch.equal(eb, gb)


def test_fused_and_legacy_steps_replay_too():
    eng = engine(True)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    for _ in range(3):
        la, lb = eng.decode_many([(a, ta), (b, tb)])  # fused: B 4, its own key
        ta, tb = greedy(la), greedy(lb)
    assert eng.step_graphs.captures == 1 and eng.step_graphs.replays == 2
    for _ in range(3):
        ta = greedy(a.decode_legacy(ta))  # B 2: a key of its own
    assert eng.step_graphs.captures == 2 and eng.step_graphs.replays == 4
    shapes = {s[3][0][0] for s in eng.step_graphs.shapes}  # the tables' B
    assert shapes == {2, 4}
    a.finish(), b.finish()


def test_outputs_are_fresh_and_lengths_per_instance():
    eng = engine(True)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    a.decode(ta), b.decode(tb)  # eager, then a capture on b's call
    held = a.decode(ta)
    kept = held.clone()
    la, lb = a._lengths, b._lengths
    assert la.data_ptr() != lb.data_ptr()
    lens_a, lens_b = la.clone(), lb.clone()
    b.decode(greedy(held))  # the same key's next replay, for another instance
    assert torch.equal(held, kept)
    assert torch.equal(a._lengths, lens_a) and torch.equal(lb, lens_b)
    assert torch.equal(a._lengths, torch.from_numpy(a._host_lens).to(torch.int32))
    assert torch.equal(b._lengths, torch.from_numpy(b._host_lens).to(torch.int32))
    static = {t.data_ptr() for g in eng.step_graphs.live() for t in g.inputs + g.outputs}
    assert not static & {held.data_ptr(), a._lengths.data_ptr(), b._lengths.data_ptr()}
    a.finish(), b.finish()


def run_sequence(graphed: bool):
    """Decode, fused decode_many and the legacy step over two instances."""
    eng = engine(graphed)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    logits = []
    for i in range(20):  # crosses a block boundary (T 16) for every row
        if i % 3 == 2:
            la, lb = eng.decode_many([(a, ta), (b, tb)])
        elif i % 5 == 4:
            la, lb = a.decode_legacy(ta), b.decode(tb)
        else:
            la, lb = a.decode(ta), b.decode(tb)
        logits += [la, lb]
        ta, tb = greedy(la), greedy(lb)
    a.finish(), b.finish()
    return logits, ops.launch_counts(), eng


def test_launch_counts_and_logits_equal_to_eager(counted_k1):
    eager, eager_counts, _ = run_sequence(False)
    ops.reset_launch_counts()
    graphed, graphed_counts, eng = run_sequence(True)
    assert eng.step_graphs.replays > 20
    assert graphed_counts == eager_counts
    fused = 6  # one K1 call a layer for both instances, else one each
    layers, dispatches = 2, 2 * (20 - fused) + fused
    assert eager_counts["paged_attention"] == layers * dispatches
    assert eager_counts["rope_kv_write"] == eager_counts["paged_attention"]
    # one norm-only call on the embedding, then one after each sub-block
    assert eager_counts["add_rms_norm"] == (2 * layers + 1) * dispatches
    for e, g in zip(eager, graphed):
        assert torch.equal(e, g)


def test_a_failed_capture_raises():
    class Refuses:
        def __call__(self, fn):
            raise RuntimeError("capture refused")

    eng = engine(False)
    eng.step_graphs = StepGraphs(Refuses())
    eng.load("m")
    a, ta = started(eng)
    a.decode(ta)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="capture refused"):
        a.decode(ta)
    assert ops.launch_counts() == before


def captured(eng, inst, tok, steps=3):
    """Decode `steps` steps (eager, capture, replays); returns the token."""
    for _ in range(steps):
        tok = greedy(inst.decode(tok))
    assert eng.step_graphs.live(inst.reg.model_id)
    return tok


def _reassembled(eng):
    # a buffer of the model leaves the engine's map: the next load moves it
    # again and re-assembles the tree the graph read
    del eng._tensors[eng.records_of("m")[0].fingerprint]
    eng.load("m")
    assert eng.last_load.tensors_h2d == 1


def _sync_evictions(eng):
    # the model is released with its instance still decoding; a second
    # model's load in a pool too small for both evicts it
    eng.release("m")
    eng.load("b")
    assert "m" not in eng._params_cache


def _evicted_reload(eng):
    eng.release("b")
    eng.load("m")


# site -> (what moves the params tree or the slab, what brings the model back)
INVALIDATIONS = {
    "load re-assembles": (_reassembled, None),
    "sync_evictions": (_sync_evictions, _evicted_reload),
    "drop_device_copies": (lambda eng: eng.drop_device_copies("m"), lambda eng: eng.load("m")),
    "slab growth": (lambda eng: eng.start_instance("m", num_pages=128), None),
}


@pytest.mark.parametrize("site", sorted(INVALIDATIONS))
def test_graph_dropped_where_params_or_slab_move(site):
    """The graph goes where what it points into moves; the instance's next
    step runs eagerly, the one after recaptures, and the logits equal an
    eager engine's over the same calls."""
    move, reload = INVALIDATIONS[site]
    outs = {}
    for graphed in (False, True):
        eng = engine(graphed, cap=3_000_000, models=(("m", 2), ("b", 2)))
        eng.load("m")
        a, ta = started(eng, seed=1)
        logits = []
        for _ in range(3):
            logits.append(a.decode(ta))
            ta = greedy(logits[-1])
        if graphed:
            g = eng.step_graphs
            assert len(g.live("m")) == 1
            dropped = g.dropped
        move(eng)
        if graphed:
            assert not g.live("m") and g.dropped == dropped + 1
            captures = g.captures
        if reload is not None:
            reload(eng)
        for _ in range(3):
            logits.append(a.decode(ta))
            ta = greedy(logits[-1])
        if graphed:
            assert g.captures == captures + 1 and len(g.live("m")) == 1
        outs[graphed] = logits
    for e, gr in zip(outs[False], outs[True]):
        assert torch.equal(e, gr)


def test_last_finish_close_and_crash_drop_graphs():
    """The last instance's finish keeps the model's key (its tree stays
    assembled); `close` and `crash` drop every key."""
    eng = engine(True)
    g = eng.step_graphs
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    captured(eng, a, ta)
    a.finish()  # b still decodes: the graph stays
    assert len(g.live("m")) == 1
    b.finish()  # the last instance: the key outlives it
    assert len(g.live("m")) == 1 and g.dropped == 0
    eng.load("m")
    c, tc = started(eng, seed=3)
    captured(eng, c, tc)
    eng.close()
    assert not len(g) and g.dropped == 1 and g.held_bytes() == 0
    d, td = started(eng, seed=4)
    captured(eng, d, td)
    eng.crash()
    assert not len(g) and g.dropped == 2 and g.held_bytes() == 0


def test_last_finish_keeps_graphs_close_and_crash_drop_them():
    """After the last `finish` the key stays live, and a new instance's
    first step replays it: no eager step, no capture, as the reference's
    next request runs its compiled step; its logits equal an eager
    engine's.  `close` and `crash` still free every key."""
    outs = {}
    for graphed in (False, True):
        eng = engine(graphed)
        eng.load("m")
        logits = []
        for seed in (1, 2):  # two requests, one after the other
            a, ta = started(eng, seed=seed)
            if graphed:
                g = eng.step_graphs
                counts = (g.eager_steps, g.captures, g.replays)
            for _ in range(4):
                logits.append(a.decode(ta))
                ta = greedy(logits[-1])
            a.finish()
            if graphed:
                made = (g.eager_steps - counts[0], g.captures - counts[1],
                        g.replays - counts[2])
                # the first request: eager, capture, 3 replays (a capture
                # replays too); the second replays from its first step
                assert made == ((1, 1, 3) if seed == 1 else (0, 0, 4)), (seed, made)
                assert len(g.live("m")) == 1 and g.dropped == 0
        outs[graphed] = logits
        if graphed:
            held = g.held_bytes()
            assert held == sum(t.nbytes for x in g.live() for t in x.inputs) > 0
            eng.close()
            assert not len(g) and g.held_bytes() == 0 and g.dropped == 1
            eng.load("m")
            c, tc = started(eng, seed=3)
            captured(eng, c, tc)
            c.finish()
            assert len(g) == 1
            eng.crash()
            assert not len(g) and g.held_bytes() == 0 and g.dropped == 2
    for e, gr in zip(outs[False], outs[True]):
        assert torch.equal(e, gr)


POOL = 1 << 20  # what each capture's private pool reports


def _key_bytes(B, blocks=64) -> int:
    # a paged key's static inputs: the token (B,), tables (B, blocks) and
    # lengths (B,), int32
    return POOL + 4 * (B + B * blocks + B)


# bound -> (StepGraphs' keyword, the bound: room for two keys of B <= 3)
BOUNDS = {"budget": ("budget", _key_bytes(2) + _key_bytes(3)),
          "limit": ("limit", 2)}


@pytest.mark.parametrize("bound", sorted(BOUNDS))
def test_budget_frees_least_recently_used_key(bound):
    """Three keys (B 1, 2, 3) under a bound that holds two: a call moves its
    key to the end, and the next key frees the least recently called one,
    by held bytes (`budget`) or by keys (`limit`); the logits equal an
    eager engine's over the same calls."""
    word, value = BOUNDS[bound]
    outs = {}
    for graphed in (False, True):
        eng = engine(graphed, models=(("m", 2),))
        if graphed:
            eng.step_graphs = g = StepGraphs(RecordingCapture(POOL), **{word: value})
        eng.load("m")
        insts = {B: started(eng, seed=B, B=B) for B in (1, 2, 3)}
        logits = []

        def step(B):
            inst, tok = insts[B]
            logits.append(inst.decode(tok))
            insts[B] = (inst, greedy(logits[-1]))

        def live():
            return sorted(int(x.inputs[0].shape[0]) for x in g.live())

        for B in (1, 1, 2, 2):  # keys B 1 and B 2 captured
            step(B)
        if graphed:
            assert live() == [1, 2] and g.held_bytes() == _key_bytes(1) + _key_bytes(2)
        step(1)  # B 1 is now the most recently called
        for B in (3, 3):  # B 3's first call and its capture free B 2
            step(B)
        if graphed:
            assert live() == [1, 3] and (g.evicted, g.dropped) == (1, 1)
            assert g.held_bytes() <= BOUNDS["budget"][1]
        for B in (2, 2):  # B 2 comes back: eager, captured, and B 1 goes
            step(B)
        if graphed:
            assert live() == [2, 3] and g.evicted == 2
            assert (g.eager_steps, g.captures) == (4, 4)
        outs[graphed] = logits
        for inst, _ in insts.values():
            inst.finish()
    for e, gr in zip(outs[False], outs[True]):
        assert torch.equal(e, gr)


def test_a_key_over_the_budget_alone_captures_and_replays():
    """A key that alone holds more than the budget still captures and
    replays; the next key's capture frees it."""
    eng = engine(False)
    eng.step_graphs = g = StepGraphs(RecordingCapture(POOL), budget=POOL // 2)
    eng.load("m")
    a, ta = started(eng, seed=1, B=2)
    captured(eng, a, ta, steps=4)
    assert g.replays == 3 and len(g) == 1 and g.held_bytes() > g.budget
    b, tb = started(eng, seed=2, B=1)
    captured(eng, b, tb)
    assert [int(x.inputs[0].shape[0]) for x in g.live()] == [1] and g.evicted == 1
    a.finish(), b.finish()


def test_release_keeps_graphs_until_the_pool_evicts():
    """Keep-alive's `retain` and `release` drop nothing: a released model
    keeps its key, and its next instance replays from its first step, until
    another model's load evicts one of its tensors."""
    eng = engine(True, cap=3_000_000, models=(("m", 2), ("b", 2)))
    g = eng.step_graphs
    eng.load("m")
    a, ta = started(eng, seed=1)
    captured(eng, a, ta)
    a.finish()
    eng.retain("m")  # warm
    eng.release("m")  # scaled to zero: evictable, still resident
    assert len(g.live("m")) == 1 and "m" in eng._params_cache
    eng.load("m")  # a full device hit: the tree stays
    b, tb = started(eng, seed=2)
    counts = (g.eager_steps, g.captures)
    captured(eng, b, tb)
    assert (g.eager_steps, g.captures) == counts
    b.finish()
    eng.load("b")  # the pool holds one model: m's tensors go
    assert not g.live("m") and "m" not in eng._params_cache and g.dropped == 1


def test_a_new_tree_or_slab_is_a_new_key():
    """A key holds the params tree by the engine's generation number and the
    slab's pages themselves, so neither can alias a later one: with the
    engine's drops disabled, a re-assembled tree and a grown slab each
    still get a fresh key (an eager first call, then a capture) instead of
    a replay of a graph over freed memory."""
    eng = engine(True)
    g = eng.step_graphs
    eng.load("m")
    a, ta = started(eng, seed=1)
    captured(eng, a, ta)
    a.finish()
    first = eng._tree_of["m"]
    eng.drop_device_copies("m")  # the tree is freed
    assert not g.live("m") and "m" not in eng._params_cache
    eng._drop_graphs = lambda **which: None  # from here on nothing drops
    eng.load("m")  # a new tree
    assert eng._tree_of["m"] != first
    b, tb = started(eng, seed=2)
    tb = captured(eng, b, tb)
    assert (g.eager_steps, g.captures) == (2, 2)
    (key,) = g.live("m")
    assert [t.data_ptr() for t in key.baked] == [t.data_ptr() for t in b.slab.pages]
    old = key.baked
    eng.start_instance("m", num_pages=128).finish()  # the slab grows, undropped
    assert b.slab.pages[0].data_ptr() not in {t.data_ptr() for t in old}
    captured(eng, b, tb)
    assert (g.eager_steps, g.captures) == (3, 3) and len(g.live("m")) == 2
    assert all(t.untyped_storage().nbytes() for t in old)  # still held by the old key
    b.finish()


def test_variant_load_keeps_the_base_graph_and_keys_its_own_tree():
    eng = engine(True)
    g = eng.step_graphs
    eng.register_variant(VariantSpec("v", "m", ("attn/wq",)))
    eng.load("m")
    a, ta = started(eng, seed=1)
    ta = captured(eng, a, ta)
    eng.load("v")  # a new tree over the base's shared tensors and its delta
    assert len(g.live("m")) == 1 and g.dropped == 0
    v, tv = started(eng, "v", seed=1)
    captured(eng, v, tv)
    assert len(g.live("v")) == 1 and len(g) == 2  # one key per tree
    eng.drop_device_copies("v")  # the variant's tree goes; the base's stays
    assert not g.live("v") and len(g.live("m")) == 1
    eng.load("v")
    captured(eng, v, tv)
    assert g.captures == 3


def test_migrate_in_drops_graphs_of_the_slab_it_grows():
    src = engine(True)
    dst = engine(True)
    for e in (src, dst):
        e.load("m")
    a, ta = started(src, seed=1, B=1)
    ta = captured(src, a, ta, steps=4)
    mig = src.migrate_out("m", "seq0")
    window = []
    for _ in range(3):
        mig.replay.append(int(ta[0]))
        window.append(a.decode(ta))
        ta = greedy(window[-1])
    c, tc = started(dst, seed=2, num_pages=16, B=1)
    captured(dst, c, tc)
    g = dst.step_graphs
    inst, replayed = dst.migrate_in(mig, num_pages=64)  # the slab grows to 64 pages
    assert [x.slab.num_pages for x in g.live("m")] == [64]
    assert g.dropped == 1 and g.captures == 2  # the replayed window recaptured
    for w, r in zip(window, replayed):
        assert torch.equal(w, r)
    assert int(inst._host_lens[0]) == int(a._host_lens[0])


def test_shape_keys_match_reference_jit_specialisations():
    """B 4, a second instance, a fused B 8 and a slab growth: the port's
    distinct keys equal the growth of the reference's compiled cache of
    `_paged_decode_step` (cleared first) over the same calls."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.serving import engine as ref_engine
    from torch_port_helpers import paired_engines

    from repro.configs import get_config as ref_config

    rc = dataclasses.replace(ref_config("llama3.2-1b").smoke(), num_layers=2,
                             vocab_size=512, dtype="float32")
    ref, port, _ = paired_engines({"m": (rc, cfg(2), 3)}, 256 << 20)
    port.step_graphs = StepGraphs(RecordingCapture())
    ref_engine._paged_decode_step.clear_cache()
    toks = [np.random.default_rng(s).integers(0, 512, (4, 24)).astype(np.int32)
            for s in (1, 2)]

    def run(eng, arr, to_dev):
        eng.load("m")
        insts = [eng.start_instance("m", num_pages=64, attn_mode="ref") for _ in toks]
        tok = [greedy_any(i.prefill({"tokens": arr(t)}), to_dev) for i, t in zip(insts, toks)]
        for _ in range(2):  # B 4, then the second instance at B 4
            tok = [greedy_any(i.decode(t), to_dev) for i, t in zip(insts, tok)]
        for _ in range(2):  # fused: B 8
            tok = [greedy_any(o, to_dev) for o in eng.decode_many(list(zip(insts, tok)))]
        grown = eng.start_instance("m", num_pages=256, attn_mode="ref")
        for _ in range(2):  # P 256
            tok = [greedy_any(i.decode(t), to_dev) for i, t in zip(insts, tok)]
        for i in insts + [grown]:
            i.finish()

    def greedy_any(logits, to_dev):
        return to_dev(np.asarray(logits.argmax(-1)).astype(np.int32))

    run(ref, jnp.asarray, jnp.asarray)
    run(port, torch.from_numpy, torch.from_numpy)
    assert ref_engine._paged_decode_step._cache_size() == 3
    assert len(port.step_graphs.shapes) == 3
    assert port.step_graphs.captures == 3
