"""The port's entry points run on the card unless the caller asks for the CPU.

Each entry point is called twice: with ``device="cpu"``, where everything it
makes must lie on the CPU, and with its default, which must be the card.
Without a card the default raises and names the way out (``device='cpu'``);
nothing falls back to the CPU by itself.  The file imports neither JAX nor
the reference package, so it runs on a GPU machine too.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import build_model, encdec, lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.tensors import flatten_params  # noqa: E402
from repro_torch.core.trace import SimModel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serverless import FleetGateway, Gateway, poisson_trace  # noqa: E402
from repro_torch.serverless.gateway import make_prefill_batch  # noqa: E402
from repro_torch.serving.engine import ChunkedTransfer, DataLoadStats, Engine  # noqa: E402

CFG = dataclasses.replace(get_config("llama3.2-1b").smoke(), dtype="float32")


def _gen():
    return torch.Generator().manual_seed(0)


def _named_numpy():
    params = build_model(CFG).init(_gen(), device="cpu")
    return {n: t.numpy() for n, t in flatten_params(params)}


ENTRY_POINTS = {
    "Model.init": lambda **kw: build_model(CFG).init(_gen(), **kw),
    "Model.make_batch": lambda **kw: build_model(CFG).make_batch(
        _gen(), ShapeConfig("t", 8, 2, "prefill"), **kw),
    "lm.init_params": lambda **kw: lm.init_params(_gen(), CFG, **kw),
    "encdec.init_params": lambda **kw: encdec.init_params(
        _gen(), get_config("whisper-tiny").smoke(), max_positions=16, **kw),
    "params_from_numpy": lambda **kw: params_from_numpy(_named_numpy(), CFG, **kw),
    "ChunkedTransfer": lambda **kw: ChunkedTransfer(chunk_bytes=64, **kw).transfer(
        [("x", torch.ones((8, 4)))], DataLoadStats()),
    "Engine": lambda **kw: Engine(1 << 20, **kw).device,
    "make_prefill_batch": lambda **kw: make_prefill_batch(_engine(**kw), "m", 8, 0),
    "Gateway": lambda **kw: _served(Gateway, [_engine(**kw)]),
    "FleetGateway": lambda **kw: _served(FleetGateway, [_engine("e0", **kw),
                                                        _engine("e1", **kw)]),
    "launch.serve": lambda **kw: [e.device for e in serve.main(
        ["--models", "llama3.2-1b", "--requests", "1", "--prompt-len", "8",
         "--gen-tokens", "1"] + (["--device", kw["device"]] if kw else []))],
}


def _engine(engine_id="engine0", **kw):
    eng = Engine(64 << 20, engine_id=engine_id, **kw)
    eng.register("m", CFG)
    return eng


def _served(gateway, engines):
    """Replay one request through the gateway; the loaded weights."""
    gw = gateway(engines[0] if gateway is Gateway else engines,
                 prompt_len=8, gen_tokens=1)
    gw.run_trace(poisson_trace(n_requests=1, models=[SimModel("m", 1e6, 1)]))
    return [t for e in engines if "m" in e._params_cache for t in
            [e.params_of("m")["embed"]]]


def _device_types(out) -> set[str]:
    if isinstance(out, torch.device):
        return {out.type}
    if isinstance(out, torch.Tensor):
        return {out.device.type}
    if isinstance(out, dict):
        out = list(out.values())
    return set().union(*(_device_types(x) for x in out))


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu(entry):
    call = ENTRY_POINTS[entry]
    assert _device_types(call(device="cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert _device_types(call()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
