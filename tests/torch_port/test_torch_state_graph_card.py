"""The compiled state-family decode step on the card: CUDA graphs of
`Model.decode` through `Engine._state_step` (`serving/step_graph.py`)
against the eager step.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

For mamba2-2.7b, recurrentgemma-9b, whisper-tiny and mixtral-8x7b at smoke
width (bf16), an eager engine (``cuda_graphs=False``) and a graphed one
over the same weights run the same calls, the graphed one fed the eager
one's tokens: one instance at B 2 for 16 steps over its ring's wrap, the
first 8 under ``torch.cuda.set_sync_debug_mode("error")`` (the first call
eager, the second the capture), the model's device copies dropped and
reloaded between steps 8 and 9, then a second instance and 8
`decode_many` steps (one by one: non-paged instances are not fused).
Logits must be equal bit for bit.  After the last `finish` the key stays
live: the next request's instance replays from its first step, bitwise
equal to eager; device memory is the eager engine's plus the live key's
tensors, and the eager engine's again after `close`.
"""
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny", "mixtral-8x7b")
B, S = 2, 40  # the rings hold round_up(40, 16) = 48 slots
NEXT = 4  # decode steps of the next request's instance
STEPS, EVICT_AT, MANY = 16, 8, 8
CHUNK = 16 << 20  # the engine's h2d chunk


# PyTorch's CUDA generator holds a graph-safe seed and offset (two int64
# tensors) while any graph is registered with it
RNG_GRAPH_STATE_BYTES = 16


def live_bytes(g) -> int:
    """Device bytes the live keys of `g` account for: their static tensors
    (`StepGraphs.static_bytes`) and the generator's graph state."""
    return g.static_bytes() + (RNG_GRAPH_STATE_BYTES if g.live() else 0)


def allocated() -> int:
    """Device bytes the live tensors requested (not the cached blocks they
    landed in), with the card idle, unreachable objects collected and the
    cuBLAS workspaces (which a capture clears) released."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def smoke(name):
    return dataclasses.replace(get_config(name).smoke(), name=name)


def prompt(cfg):
    return build_model(cfg).make_batch(torch.Generator().manual_seed(5),
                                       ShapeConfig("card", S, B, "prefill"), device="cuda")


def run(eng: Engine, cfg, batch, fed=None) -> dict:
    m, g = cfg.name, eng.step_graphs
    feed = iter(fed) if fed is not None else None
    out = {"logits": [], "tokens": [], "marks": {}, "next": []}

    def take(logits, into="logits"):
        out[into].append(logits)
        # a fed token is copied, so both runs allocate what they hold
        tok = next(feed).clone() if feed is not None else logits.argmax(-1).to(torch.int32)
        out["tokens"].append(tok)
        return tok

    def mark(what):
        if g is not None:
            out["marks"][what] = (g.captures, len(g.live(m)))

    base = allocated()
    a = eng.start_instance(m)
    ta = take(a.prefill(batch))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(EVICT_AT):
            ta = take(a.decode(ta))
        mark("window")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.drop_device_copies(m)
    mark("evicted")
    eng.load(m)
    for _ in range(STEPS - EVICT_AT):
        ta = take(a.decode(ta))
    mark("reloaded")
    b = eng.start_instance(m)
    tb = take(b.prefill(batch))
    for _ in range(MANY):
        la, lb = eng.decode_many([(a, ta), (b, tb)])
        ta, tb = take(la), take(lb)
    mark("shared")
    a.finish(), b.finish()
    mark("finished")
    out["allocated"] = allocated() - base
    if g is not None:
        out["live"] = live_bytes(g)
        out["held"] = g.held_bytes()
        counts = (g.eager_steps, g.captures, g.replays)
    # the next request: a fresh instance over the same tree
    c = eng.start_instance(m)
    tc = take(c.prefill(batch), "next")
    for _ in range(NEXT):
        tc = take(c.decode(tc), "next")
    c.finish()
    if g is not None:
        out["next_counts"] = (g.eager_steps - counts[0], g.captures - counts[1],
                              g.replays - counts[2])
    eng.close()
    out["closed"] = allocated() - base
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = smoke(request.param)
    batch = prompt(cfg)
    out = {}
    for route in ("eager", "graphed"):
        eng = Engine(256 << 20, cuda_graphs=route == "graphed", engine_id=route)
        eng.register(cfg.name, cfg)  # the same crc32-seeded weights on both
        eng.load(cfg.name)
        out[route] = run(eng, cfg, batch, out["eager"]["tokens"] if out else None)
        out[route]["engine"] = eng
    yield cfg, out
    for r in out.values():
        r["engine"].close()


def test_graphed_logits_equal_eager_bitwise(runs):
    _, out = runs
    eager, graphed = out["eager"]["logits"], out["graphed"]["logits"]
    assert len(eager) == len(graphed) == 2 + STEPS + 2 * MANY
    for i, (e, g) in enumerate(zip(eager, graphed)):
        assert torch.equal(e, g), i
    assert all(bool(torch.isfinite(g.float()).all()) for g in graphed)


def test_capture_inside_sync_error_window(runs):
    _, out = runs
    g = out["graphed"]["engine"].step_graphs
    assert out["eager"]["engine"].step_graphs is None
    assert out["graphed"]["marks"]["window"] == (1, 1)
    # steps 2-8 and 10-16 replay (a capture replays once), both instances'
    # decode_many steps, and every step of the next request's instance
    assert g.eager_steps == 2 and g.replays == STEPS - 2 + 2 * MANY + NEXT


def test_eviction_drops_and_reload_recaptures(runs):
    _, out = runs
    marks = out["graphed"]["marks"]
    assert marks["evicted"] == (1, 0)
    assert marks["reloaded"] == (2, 1)
    assert marks["shared"] == (2, 1)  # the second instance's cache has the same shapes
    assert marks["finished"] == (2, 1)  # the key outlives the instances


def test_memory_back_to_eager_after_finish(runs):
    """Memory back to the eager engine's after `close`; after `finish` the
    graphed engine holds exactly its live keys' tensors more, within the
    budget."""
    _, out = runs
    g = out["graphed"]["engine"].step_graphs
    assert g.pool_bytes_captured > 0 and g.pool_bytes() == 0
    graphed, eager = out["graphed"], out["eager"]
    assert graphed["allocated"] == eager["allocated"] + graphed["live"], (
        graphed["allocated"], eager["allocated"], graphed["live"])
    assert 0 < graphed["live"] <= graphed["held"] <= g.budget
    # both engines also hold the next request's logits by then
    assert graphed["closed"] == eager["closed"], (graphed["closed"], eager["closed"])


def test_next_instance_after_finish_replays_from_its_first_step(runs):
    """After the last `finish` the keys stay live: the next instance's
    decode replays from its first step (no eager step, no capture), its
    logits bitwise equal to the eager engine's."""
    _, out = runs
    assert out["graphed"]["next_counts"] == (0, 0, NEXT)
    eager, graphed = out["eager"]["next"], out["graphed"]["next"]
    assert len(eager) == len(graphed) == 1 + NEXT
    for i, (e, g) in enumerate(zip(eager, graphed)):
        assert torch.equal(e, g), i


@pytest.mark.parametrize("name", ARCHS)
def test_crash_gives_the_graphs_pools_back(name, cuda_device):
    cfg = smoke(name)
    batch = prompt(cfg)
    torch.cuda.empty_cache()
    base, reserved = allocated(), torch.cuda.memory_reserved()
    eng = Engine(256 << 20, engine_id="crash")
    eng.register(name, cfg)
    eng.load(name)
    inst = eng.start_instance(name)
    tok = inst.prefill(batch).argmax(-1).to(torch.int32)
    for _ in range(3):
        tok = inst.decode(tok).argmax(-1).to(torch.int32)
    g = eng.step_graphs
    assert len(g.live(name)) == 1 and g.pool_bytes() > 0
    eng.crash()
    assert not len(g) and g.pool_bytes() == 0 and g.dropped == 1
    del inst, tok
    after = allocated()
    torch.cuda.empty_cache()
    assert after - base <= CHUNK, (base, after)
    assert torch.cuda.memory_reserved() - reserved <= CHUNK
    eng.close()
