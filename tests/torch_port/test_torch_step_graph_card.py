"""The compiled paged decode step on the card: CUDA graphs of
`_paged_decode_step` (`serving/step_graph.py`) against the eager step.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

For a dense, a MoE and a VLM model at smoke width (bf16, 4 layers, head
dim 32), an eager engine (``cuda_graphs=False``) and a graphed one over the
same weights run the same calls, the graphed one fed the eager one's
tokens: one instance at B 2 for 16 steps under
``torch.cuda.set_sync_debug_mode("error")`` (the first call eager, the
second the capture), the model's device copies dropped and reloaded
between steps 8 and 9, then a second instance and 8 fused `decode_many`
steps at B 4.  Logits must be equal bit for bit, or within the bf16
tolerance of scale (2e-2) with any changed greedy token a tie within it.
After the last `finish` the keys stay live: the next request's instance
replays from its first step, bitwise equal to eager; device memory is the
eager engine's plus the live keys' tensors, and the eager engine's again
after `close`.
"""
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "qwen2-vl-7b")
B, S = 2, 40
NEXT = 4  # decode steps of the next request's instance
STEPS, EVICT_AT, FUSED = 16, 8, 8
TOL = 2e-2  # bf16, relative to the logits' scale (tests/test_kernels.py)


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

    ops.reset_launch_counts()
    base = allocated()
    a = eng.start_instance(m, num_pages=64)
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
    b = eng.start_instance(m, num_pages=64)
    tb = take(b.prefill(batch))
    for _ in range(FUSED):
        la, lb = eng.decode_many([(a, ta), (b, tb)])
        ta, tb = take(la), take(lb)
    out["launches"] = ops.launch_counts()
    a.finish(), b.finish()
    mark("finished")
    out["allocated"] = allocated() - base
    if g is not None:
        out["live"] = live_bytes(g)
        out["held"] = g.held_bytes()
        counts = (g.eager_steps, g.captures, g.replays)
    # the next request: a fresh instance over the same tree
    c = eng.start_instance(m, num_pages=64)
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
    cfg = dataclasses.replace(get_config(request.param).smoke(), name=request.param)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(3),
                                        ShapeConfig("card", S, B, "prefill"), device="cuda")
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


def test_graphed_logits_equal_eager(runs):
    _, out = runs
    eager, graphed = out["eager"]["logits"], out["graphed"]["logits"]
    assert len(eager) == len(graphed) == 2 + STEPS + 2 * FUSED
    for i, (e, g) in enumerate(zip(eager, graphed)):
        if torch.equal(e, g):
            continue
        e, g = e.float(), g.float()
        scale = max(1.0, float(e.abs().max()))
        assert float((e - g).abs().max()) <= TOL * scale, i
        et, gt = e.argmax(-1), g.argmax(-1)
        for row in torch.nonzero(et != gt).flatten().tolist():
            assert float(e[row, et[row]] - e[row, gt[row]]) <= TOL * scale, (i, row)


def test_launch_counts_equal_eager(runs):
    cfg, out = runs
    # the MoE layers take the routed experts at B 2 (T * k = 4 < 8 experts),
    # the slot path in the fused B 4 steps (8 = 8)
    want = {"paged_attention": cfg.num_layers * (STEPS + FUSED),
            "flash_attention": cfg.num_layers * 2,
            "moe_experts": cfg.num_layers * STEPS if cfg.is_moe else 0,
            "rope_kv_write": cfg.num_layers * (STEPS + FUSED),
            # a norm-only call on the embedding, then one after each sub-block
            "add_rms_norm": (2 * cfg.num_layers + 1) * (STEPS + FUSED)}
    assert out["eager"]["launches"] == out["graphed"]["launches"] == want


def test_capture_inside_sync_error_window(runs):
    _, out = runs
    g = out["graphed"]["engine"].step_graphs
    assert out["eager"]["engine"].step_graphs is None
    assert out["graphed"]["marks"]["window"] == (1, 1)
    assert g.eager_steps >= 1 and g.replays >= STEPS + FUSED - 3


def test_eviction_drops_and_reload_recaptures(runs):
    _, out = runs
    marks = out["graphed"]["marks"]
    assert marks["evicted"] == (1, 0)
    assert marks["reloaded"] == (2, 1)
    assert marks["finished"] == (3, 2)  # the fused key's; it and the B 2 key stay live


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