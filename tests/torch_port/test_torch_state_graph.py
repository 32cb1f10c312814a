"""The compiled state-family decode step (`Engine._state_step` through
`serving/step_graph.py`) on the CPU.

The engine's non-paged fallback (mamba2-2.7b, recurrentgemma-9b,
whisper-tiny and mixtral-8x7b's SWA ring) decodes through `Model.decode`,
which the reference runs as one compiled layer scan a segment.  On a CUDA
engine the port captures the step as a CUDA graph per key (the config, the
shapes and dtypes of the token, the positions and every cache leaf, and
the params tree's identity) on the key's second call and replays it after.
A CPU engine never captures, so these tests inject `RecordingCapture`, the
double of `CudaGraphCapture` (its capture runs the eager step once, its
replay reruns it into the static outputs), and hold the graphed engine
against an eager one over the same calls: the key policy, the replay
contract (the input cache untouched, fresh outputs, Whisper's cross caches
handed back as the caller's own tensors), interleaved instances, every
site that must drop a graph, and a capture that fails.  Last, the
reference's fault the port does not copy: its scan is traced and compiled
again on every `Model.decode` call at fixed shapes, where the port keeps
one key.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.tensors import flatten_params, spec_records  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.step_graph import StepGraphs  # noqa: E402

from torch_port_helpers import RecordingCapture  # noqa: E402

FAMILIES = ["mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny", "mixtral-8x7b"]
PROMPT = 12  # the rings hold round_up(12, 16) = 16 slots
STEPS = 10  # positions 12..21: the ring wraps at 16


def cfg(name):
    return dataclasses.replace(port_config(name).smoke(), dtype="float32")


def engine(name, graphed: bool, cap=256 << 20, models=("m",)) -> Engine:
    eng = Engine(cap, device="cpu")
    for mid in models:
        eng.register(mid, cfg(name))
    if graphed:
        eng.step_graphs = StepGraphs(RecordingCapture())
    return eng


def prompt(c, S=PROMPT, seed=0) -> dict:
    """A B 1 prompt from numpy with a seed (and encoder frames for Whisper)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, c.vocab_size, (1, S)).astype(np.int32))}
    if c.family == "audio":
        batch["enc_frames"] = torch.from_numpy(
            (rng.standard_normal((1, c.encoder_seq, c.d_model)) * 0.02).astype(np.float32))
    return batch


def greedy(logits):
    return logits.argmax(-1).to(torch.int32)


def started(eng, mid="m", seed=0, S=PROMPT):
    inst = eng.start_instance(mid)
    return inst, greedy(inst.prefill(prompt(eng.models[mid].cfg, S, seed)))


def leaves(cache) -> list:
    return [t for _, t in flatten_params(cache)]


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_cpu_engine_never_captures():
    eng = Engine(1 << 30, device="cpu", cuda_graphs=True)
    assert eng.step_graphs is None
    eng.register("m", cfg("mamba2-2.7b"))
    eng.load("m")
    a, ta = started(eng)
    for _ in range(3):
        ta = greedy(a.decode(ta))
    assert eng.step_graphs is None
    a.finish()


@pytest.mark.parametrize("name", FAMILIES)
def test_first_call_eager_second_captures_then_replays_shared_by_instances(name):
    outs = {}
    for graphed in (False, True):
        eng = engine(name, graphed)
        eng.load("m")
        a, ta = started(eng, seed=1)
        b, tb = started(eng, seed=2)
        steps = []
        for i in range(4):
            la = a.decode(ta)
            if graphed:
                g = eng.step_graphs
                # the key's first call (a's) runs eagerly, its second (b's)
                # captures and replays, every later call replays
                assert (g.eager_steps, g.captures, g.replays) == (1, min(i, 1), 2 * i), i
            lb = b.decode(tb)  # equal cache shapes: a's key
            steps.append((la, lb, a._cache, b._cache))
            ta, tb = greedy(la), greedy(lb)
        if graphed:
            assert (g.eager_steps, g.captures, len(g), len(g.shapes)) == (1, 1, 1, 1)
            assert g.replays == 7 and g.capture.replayed == 7
            assert len(g.live("m")) == 1
        outs[graphed] = steps
        a.finish(), b.finish()
        eng.close()
    for i, (e, gr) in enumerate(zip(outs[False], outs[True])):
        assert torch.equal(e[0], gr[0]) and torch.equal(e[1], gr[1]), i
        assert same(e[2], gr[2]) and same(e[3], gr[3]), i


@pytest.mark.parametrize("name", ["mamba2-2.7b", "mixtral-8x7b"])
def test_a_key_per_cache_shape(name):
    """A longer prompt's ring has more slots, so its key is its own; a
    Mamba2 state does not grow with the prompt, so both share one key."""
    eng = engine(name, True)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2, S=PROMPT + 16)
    for _ in range(3):
        ta, tb = greedy(a.decode(ta)), greedy(b.decode(tb))
    g = eng.step_graphs
    keys = 1 if name == "mamba2-2.7b" else 2
    assert (len(g.shapes), len(g), g.eager_steps) == (keys, keys, keys)
    a.finish(), b.finish()


def run_sequence(name, graphed: bool):
    """Two instances interleaved over the ring's wrap, through `decode`,
    `decode_legacy` (which defers to it) and `decode_many` (one by one)."""
    eng = engine(name, graphed)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    out = []
    for i in range(STEPS):
        if i % 3 == 2:
            la, lb = eng.decode_many([(a, ta), (b, tb)])
        elif i % 4 == 3:
            lb, la = b.decode_legacy(tb), a.decode_legacy(ta)
        else:
            la, lb = a.decode(ta), b.decode(tb)
        out.append((la, lb, a._cache, b._cache))
        ta, tb = greedy(la), greedy(lb)
    a.finish(), b.finish()
    return out, eng


@pytest.mark.parametrize("name", FAMILIES)
def test_logits_and_caches_equal_eager_over_the_ring_wrap(name):
    eager, _ = run_sequence(name, False)
    graphed, eng = run_sequence(name, True)
    assert eng.step_graphs.replays == 2 * STEPS - 1
    for i, (e, g) in enumerate(zip(eager, graphed)):
        assert torch.equal(e[0], g[0]) and torch.equal(e[1], g[1]), i
        assert same(e[2], g[2]) and same(e[3], g[3]), i
    assert torch.isfinite(graphed[-1][0]).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_input_cache_untouched_and_outputs_fresh(name):
    """A replay leaves the caller's cache as it was and returns tensors of
    its own: no static buffer of the graph, none of the caller's, but for
    the leaves the step passes through (Whisper's cross caches), which are
    the caller's very tensors."""
    eng = engine(name, True)
    eng.load("m")
    a, ta = started(eng, seed=1)
    b, tb = started(eng, seed=2)
    a.decode(ta), b.decode(tb)  # eager, then a capture on b's call
    before = a._cache
    kept = [t.clone() for t in leaves(before)]
    logits = a.decode(ta)  # a replay
    after = a._cache
    assert all(torch.equal(t, k) for t, k in zip(leaves(before), kept))
    (g,) = eng.step_graphs.live("m")
    static = {t.data_ptr() for t in g.inputs + g.outputs}
    passed = {"cross_k", "cross_v"} if name == "whisper-tiny" else set()
    for (path, new), old in zip(flatten_params(after), leaves(before)):
        if path in passed:
            assert new is old, path
            continue
        assert new.data_ptr() not in static and new.data_ptr() != old.data_ptr(), path
    assert [j is not None for j in g.passed].count(True) == len(passed)
    assert logits.data_ptr() not in static
    # b's replay of the same key leaves a's outputs as they were
    held = [t.clone() for t in leaves(after)], logits.clone()
    b.decode(tb)
    assert all(torch.equal(t, k) for t, k in zip(leaves(after), held[0]))
    assert torch.equal(logits, held[1])
    a.finish(), b.finish()


def model_bytes(name) -> int:
    return sum(r.nbytes for r in spec_records("m", cfg(name)))


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


# site -> (what moves the params tree, what brings the model back)
INVALIDATIONS = {
    "load re-assembles": (_reassembled, None),
    "sync_evictions": (_sync_evictions, _evicted_reload),
    "drop_device_copies": (lambda eng: eng.drop_device_copies("m"), lambda eng: eng.load("m")),
}


@pytest.mark.parametrize("site", sorted(INVALIDATIONS))
@pytest.mark.parametrize("name", ["mamba2-2.7b", "whisper-tiny"])
def test_graph_dropped_where_params_move(name, site):
    """The graph goes where the tree it read moves; the instance's next
    step runs eagerly, the one after recaptures, and the logits and caches
    equal an eager engine's over the same calls."""
    move, reload = INVALIDATIONS[site]
    outs = {}
    for graphed in (False, True):
        eng = engine(name, graphed, cap=model_bytes(name) * 3 // 2, models=("m", "b"))
        eng.load("m")
        a, ta = started(eng, seed=1)
        steps = []
        for _ in range(3):
            steps.append((a.decode(ta), a._cache))
            ta = greedy(steps[-1][0])
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
            steps.append((a.decode(ta), a._cache))
            ta = greedy(steps[-1][0])
        if graphed:
            assert g.captures == captures + 1 and len(g.live("m")) == 1
        outs[graphed] = steps
    for (el, ec), (gl, gc) in zip(outs[False], outs[True]):
        assert torch.equal(el, gl) and same(ec, gc)


def captured(eng, inst, tok, steps=3):
    """Decode `steps` steps (eager, capture, replays); returns the token."""
    for _ in range(steps):
        tok = greedy(inst.decode(tok))
    assert eng.step_graphs.live(inst.reg.model_id)
    return tok


@pytest.mark.parametrize("name", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_last_finish_close_and_crash_drop_graphs(name):
    """The last instance's finish keeps the model's key (its tree stays
    assembled); `close` and `crash` drop every key."""
    eng = engine(name, True)
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


@pytest.mark.parametrize("name", FAMILIES)
def test_last_finish_keeps_graphs_close_and_crash_drop_them(name):
    """After the last `finish` the key stays live, and the next request's
    instance replays it from its first step (no eager step, no capture);
    its logits and caches equal an eager engine's.  The key holds the
    cache's static copy beside its pool; `close` and `crash` free it."""
    outs = {}
    for graphed in (False, True):
        eng = engine(name, graphed)
        eng.load("m")
        steps = []
        for seed in (1, 2):
            a, ta = started(eng, seed=seed)
            if graphed:
                g = eng.step_graphs
                counts = (g.eager_steps, g.captures, g.replays)
            for _ in range(4):
                steps.append((a.decode(ta), a._cache))
                ta = greedy(steps[-1][0])
            a.finish()
            if graphed:
                made = (g.eager_steps - counts[0], g.captures - counts[1],
                        g.replays - counts[2])
                assert made == ((1, 1, 3) if seed == 1 else (0, 0, 4)), (seed, made)
                assert len(g.live("m")) == 1 and g.dropped == 0
        outs[graphed] = steps
        if graphed:
            (key,) = g.live("m")
            assert g.held_bytes() == sum(t.nbytes for t in key.inputs)
            assert g.held_bytes() > sum(t.nbytes for t in leaves(a._cache)) > 0
            eng.close()
            assert not len(g) and g.held_bytes() == 0
            eng.load("m")
            c, tc = started(eng, seed=3)
            captured(eng, c, tc)
            c.finish()
            eng.crash()
            assert not len(g) and g.held_bytes() == 0 and g.dropped == 2
    for (el, ec), (gl, gc) in zip(outs[False], outs[True]):
        assert torch.equal(el, gl) and same(ec, gc)


def test_paged_and_state_steps_share_one_graph_cache():
    """One engine's `StepGraphs` keys both steps: a paged model's and a
    state model's graphs live side by side, outlive their instances and
    drop by model."""
    eng = Engine(256 << 20, device="cpu")
    eng.register("dense", dataclasses.replace(port_config("llama3.2-1b").smoke(),
                                              num_layers=2, vocab_size=512, dtype="float32"))
    eng.register("ssm", cfg("mamba2-2.7b"))
    eng.step_graphs = g = StepGraphs(RecordingCapture())
    insts = {}
    for mid in ("dense", "ssm"):
        eng.load(mid)
        insts[mid] = started(eng, mid, seed=1)
        captured(eng, *insts[mid])
    assert len(g) == 2 and {x.slab is None for x in g.live()} == {True, False}
    for inst, _ in insts.values():
        inst.finish()
    assert len(g) == 2
    eng.drop_device_copies("ssm")
    assert [x.model_id for x in g.live()] == ["dense"]
    eng.drop_device_copies("dense")
    assert not len(g)


def test_a_failed_capture_raises():
    class Refuses:
        def __call__(self, fn):
            raise RuntimeError("capture refused")

    eng = engine("whisper-tiny", False)
    eng.step_graphs = StepGraphs(Refuses())
    eng.load("m")
    a, ta = started(eng)
    a.decode(ta)
    cache, lens = a._cache, a._host_lens.copy()
    with pytest.raises(RuntimeError, match="capture refused"):
        a.decode(ta)
    assert a._cache is cache and np.array_equal(a._host_lens, lens)


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_scan_recompiles_every_step_port_keeps_one_key(name):
    """The reference's `Model.decode` builds a fresh scan body on every
    call, so at fixed shapes each call misses the cache of compiled
    primitives (`xla_primitive_callable`) and compiles again; the port's
    graphed engine keys the same calls once."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax._src import dispatch

    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build

    rc = dataclasses.replace(ref_config(name).smoke(), dtype="float32")
    model = ref_build(rc)
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v.numpy()) for k, v in prompt(rc).items()}
    logits, cache = model.prefill(params, batch, cache_cap=16)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    misses = []
    for i in range(3):
        before = dispatch.xla_primitive_callable.cache_info().misses
        out, cache = model.decode(params, tok, jnp.full((1,), PROMPT + i, jnp.int32), cache)
        jax.block_until_ready(out)
        misses.append(dispatch.xla_primitive_callable.cache_info().misses - before)
        tok = jnp.argmax(out, -1).astype(jnp.int32)
    assert min(misses) >= 1, misses

    eng = engine(name, True)
    eng.load("m")
    a, ta = started(eng)
    for _ in range(3):
        ta = greedy(a.decode(ta))
    g = eng.step_graphs
    assert (len(g.shapes), len(g._graphs), g.captures) == (1, 1, 1)
    a.finish()
