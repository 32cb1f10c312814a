"""The port's device-ended spans on the card.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port/test_torch_tracing_card.py

A traced CUDA engine at smoke width (bf16, 2 layers) serves a request
through `gateway.generate`, whose decode loop runs under
``torch.cuda.set_sync_debug_mode("error")``: recording the spans' timing
events must not sync.  Each step's ``done`` is resolved at `finish`; a
replayed step's ``done`` less its host begin is at least the step's device
time measured alone (between CUDA events, behind a device spin, so the
host's launches do not pace it).
"""
import dataclasses
import statistics

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serverless.gateway import generate, greedy  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

STEPS, ALONE = 12, 8


@pytest.fixture(scope="module")
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans end on its events")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), num_layers=2)
    model = build_model(cfg)
    weights = model.init(torch.Generator().manual_seed(0), device="cpu")
    tracer = Tracer()
    eng = Engine(1 << 30, device=dev, tracer=tracer)
    eng.register("m", cfg, init_fn=lambda: weights)
    eng.load("m", rid=0)
    inst = eng.start_instance("m", num_pages=64, rid=0)
    batch = model.make_batch(torch.Generator().manual_seed(1),
                             ShapeConfig("t", 40, 1, "prefill"), device=dev)
    generate(inst, batch, STEPS)  # raises on any host sync in the decode loop
    assert len(eng.clock._pending) == 2 + STEPS  # the prefill's two children, each step
    tok = greedy(inst.decode(torch.zeros(1, dtype=torch.int32, device=dev)))
    alone = []
    for _ in range(ALONE):  # one replayed step at a time, the device spinning first
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        tok = greedy(inst.decode(tok))
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end) / 1e3)
    inst.finish()
    events = tracer.events()
    eng.close()
    return events, alone


def test_every_step_resolved_with_its_kind(served):
    events, _ = served
    steps = sorted((e for e in events if e.name.startswith("decode.")), key=lambda e: e.begin)
    assert [e.name for e in steps] == (["decode.eager", "decode.capture"]
                                       + ["decode.replay"] * (STEPS - 1 + ALONE))
    kids = [e for e in events if e.name in ("prefill.forward", "prefill.kv")]
    assert len(kids) == 2
    for e in steps + kids:
        assert e.args["rid"] == 0 and e.args["done"] >= e.begin, e
    dones = [e.args["done"] for e in steps]
    assert dones == sorted(dones)  # one stream: the device finishes them in order
    (finish,) = [e for e in events if e.name == "instance.finish"]
    assert dones[-1] <= finish.end  # resolved inside it


def test_a_replay_lasts_at_least_its_device_time(served):
    """The loop's replays (those timed alone began behind a spin)."""
    events, alone = served
    steps = sorted((e for e in events if e.name.startswith("decode.")), key=lambda e: e.begin)
    replays = [e.args["done"] - e.begin for e in steps[2:STEPS]]
    assert statistics.median(replays) >= statistics.median(alone), (replays, alone)
    assert min(replays) >= 0.9 * min(alone), (replays, alone)
