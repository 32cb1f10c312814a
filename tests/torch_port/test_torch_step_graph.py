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
    """K1's CPU path counted as the CUDA wrapper counts a launch."""
    real = ops.paged_attention

    def k1(*args):
        real.launches += 1
        return real(*args)

    monkeypatch.setattr(ops, "paged_attention", k1)
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
    assert eager_counts["paged_attention"] == 2 * (2 * (20 - fused) + fused)
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
    eng = engine(True)
    g = eng.step_graphs
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    captured(eng, a, ta)
    a.finish()  # b still decodes: the graph stays
    assert len(g.live("m")) == 1
    b.finish()  # the last instance: its pool leaves the card
    assert not g.live("m") and g.dropped == 1
    eng.load("m")
    c, tc = started(eng, seed=3)
    captured(eng, c, tc)
    eng.close()
    assert not len(g) and g.dropped == 2
    d, td = started(eng, seed=4)
    captured(eng, d, td)
    eng.crash()
    assert not len(g) and g.dropped == 3


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
