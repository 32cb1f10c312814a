"""The Engine's non-paged (state-family) fallback against the reference's:
the four families the paged path does not admit (`_is_paged_family`) --
mamba2-2.7b (SSD states), recurrentgemma-9b (RG-LRU states + SWA rings),
whisper-tiny (encoder-decoder) and mixtral-8x7b (MoE + SWA ring) -- driven
by tests/test_engine.py::test_state_family_fallback_decode's sequence
(register, load, start_instance, prefill of a 2 x 32 batch, decode,
finish), then greedy decode: equal `LoadReport` / `DataLoadStats` ledgers,
an equal pool (the state caches and rings live outside ElasticKV, which
allocates nothing for them), logits within 1e-4 (fp32 smoke models) and
equal greedy tokens.  Also: `decode_many` steps non-paged instances one by
one, `migrate_out` refuses them, a crash drops their state, and a `Gateway`
trace over two state families replays as the reference's does.

MoE expert choices are the reference's, replayed (`RouterReplay`).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.serverless as ref_sl  # noqa: E402
import repro_torch.serverless as port_sl  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.trace import SimModel as RefSimModel  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.trace import SimModel as PortSimModel  # noqa: E402
from test_torch_moe import RouterReplay  # noqa: E402
from test_torch_serverless import RecPort, RecRef, plain  # noqa: E402

from torch_port_helpers import load_ledger, load_report, max_err, paired_engines  # noqa: E402

FAMILIES = ["mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny", "mixtral-8x7b"]
LOGIT_TOL = 1e-4  # fp32: the same math summed in another order


def cfgs(name, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_config(name).smoke(), **over),
            dataclasses.replace(port_config(name).smoke(), **over))


def batches(rc, B, S, seed):
    """The same prompt batch for both packages, from numpy with a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if rc.family == "audio":
        f = (rng.standard_normal((B, rc.encoder_seq, rc.d_model)) * 0.02).astype(np.float32)
        ref["enc_frames"], port["enc_frames"] = jnp.asarray(f), torch.from_numpy(f)
    return ref, port


@pytest.fixture
def router_replay(monkeypatch):
    replay = RouterReplay(monkeypatch)
    yield replay
    jax.clear_caches()


@pytest.mark.parametrize("name", FAMILIES)
def test_state_family_fallback_matches_reference(name, router_replay):
    rc, pc = cfgs(name)
    ref, port, _ = paired_engines({"m": (rc, pc, 21)})
    assert load_report(port.load("m")) == load_report(ref.load("m"))
    assert load_ledger(port) == load_ledger(ref)
    ri, pi = ref.start_instance("m"), port.start_instance("m")
    free = port.store.free_bytes()
    assert free == ref.store.free_bytes()
    rb, pb = batches(rc, 2, 32, 22)
    rl, pl = ri.prefill(rb), pi.prefill(pb)
    assert not ri.paged and not pi.paged and pi.slab is None
    assert max_err(pl, rl) < LOGIT_TOL
    toks = []
    for step in range(6):
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(pl, -1).numpy(), tok), step
        toks.append(tok)
        rl, pl = ri.decode(jnp.asarray(tok)), pi.decode(torch.from_numpy(tok))
        assert max_err(pl, rl) < LOGIT_TOL, step
        assert np.array_equal(pi._host_lens, ri._host_lens)
    assert torch.isfinite(pl).all()
    # the state caches never touch the pool: ElasticKV allocated nothing
    assert port.store.free_bytes() == ref.store.free_bytes() == free
    assert not pi.kv.block_tables and not ri.kv.block_tables
    ri.finish(), pi.finish()
    assert port.store.free_bytes() == ref.store.free_bytes()
    assert port._live_instances == {} == ref._live_instances
    assert load_report(port.load("m")) == load_report(ref.load("m"))  # warm
    assert load_ledger(port) == load_ledger(ref)
    router_replay.done()
    ref.close(), port.close()


@pytest.mark.parametrize("name", ["mamba2-2.7b", "whisper-tiny"])
def test_decode_many_steps_state_instances_one_by_one(name):
    """Two non-paged instances of one model through `decode_many`: each is
    its own group (`__solo__`), so the step equals their own `decode`s bit
    for bit, and both equal the reference's `decode_many`."""
    rc, pc = cfgs(name)
    ref, port, _ = paired_engines({"m": (rc, pc, 23)})
    ref.load("m"), port.load("m")
    insts = {}
    for tag in ("a", "b", "c"):  # a, b: decode_many; c: b's own decode
        seed = 24 if tag == "a" else 25
        rb, pb = batches(rc, 1, 16, seed)
        ri, pi = ref.start_instance("m"), port.start_instance("m")
        insts[tag] = (ri, pi, ri.prefill(rb), pi.prefill(pb))
    tok = {t: np.asarray(jnp.argmax(v[2], -1)).astype(np.int32) for t, v in insts.items()}
    for _ in range(3):
        ra, rb_ = ref.decode_many([(insts[t][0], jnp.asarray(tok[t])) for t in "ab"])
        pa, pb_ = port.decode_many([(insts[t][1], torch.from_numpy(tok[t])) for t in "ab"])
        pc_ = insts["c"][1].decode(torch.from_numpy(tok["c"]))
        assert torch.equal(pb_, pc_)
        assert max_err(pa, ra) < LOGIT_TOL and max_err(pb_, rb_) < LOGIT_TOL
        tok = {"a": np.asarray(jnp.argmax(ra, -1)).astype(np.int32),
               "b": np.asarray(jnp.argmax(rb_, -1)).astype(np.int32),
               "c": torch.argmax(pc_, -1).numpy().astype(np.int32)}
        assert np.array_equal(tok["b"], tok["c"])
    for ri, pi, _, _ in insts.values():
        ri.finish(), pi.finish()
    ref.close(), port.close()


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mixtral-8x7b"])
def test_migrate_out_refuses_a_state_instance(name):
    rc, pc = cfgs(name)
    ref, port, _ = paired_engines({"m": (rc, pc, 26)})
    ref.load("m"), port.load("m")
    rb, pb = batches(rc, 1, 16, 27)
    ri, pi = ref.start_instance("m"), port.start_instance("m")
    ri.prefill(rb), pi.prefill(pb)
    for eng in (ref, port):
        with pytest.raises(ValueError, match="no live paged instance"):
            eng.migrate_out("m", "seq0")
    ri.finish(), pi.finish()
    ref.close(), port.close()


def test_crash_drops_a_live_state_cache():
    rc, pc = cfgs("mamba2-2.7b")
    ref, port, _ = paired_engines({"m": (rc, pc, 28)})
    ref.load("m"), port.load("m")
    rb, pb = batches(rc, 1, 16, 29)
    ri, pi = ref.start_instance("m"), port.start_instance("m")
    ri.prefill(rb), pi.prefill(pb)
    assert pi._cache is not None
    ref.crash(), port.crash()
    assert pi._cache is None and pi._lengths is None
    assert port.fault_summary() == ref.fault_summary()
    assert load_report(port.load("m")) == load_report(ref.load("m"))  # cold again
    assert load_ledger(port) == load_ledger(ref)
    ref.close(), port.close()


# ------------------------------------------------------------- Gateway trace
GW_MODELS = {"mamba2-2.7b": 31, "whisper-tiny": 32}
PROMPT, GEN = 12, 3


def _gateway(gw_cls, to_batch):
    class NumpyBatches(gw_cls):
        def _prefill_batch(self, model_id, seed):
            cfg = self.engine.models[model_id].cfg
            rng = np.random.default_rng(seed)
            batch = {"tokens": to_batch(rng.integers(0, cfg.vocab_size, (1, self.prompt_len))
                                        .astype(np.int32))}
            if cfg.family == "audio":
                batch["enc_frames"] = to_batch(
                    (rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)) * 0.02)
                    .astype(np.float32))
            return batch
    return NumpyBatches


@pytest.mark.parametrize("keep_alive,seed", [("fixed:45", 3), ("zero", 5)])
def test_gateway_over_state_families_matches_reference(keep_alive, seed):
    models = {m: (*cfgs(m), s) for m, s in GW_MODELS.items()}
    ref, port, _ = paired_engines(models, 256 << 20, ref_cls=RecRef, port_cls=RecPort)
    out = []
    for gw_cls, eng, sim, to_batch in ((ref_sl.Gateway, ref, RefSimModel, jnp.asarray),
                                       (port_sl.Gateway, port, PortSimModel,
                                        torch.from_numpy)):
        eng._init_rec()
        gw = _gateway(gw_cls, to_batch)(eng, keep_alive=keep_alive, prompt_len=PROMPT,
                                        gen_tokens=GEN)
        mod = ref_sl if gw_cls is ref_sl.Gateway else port_sl
        trace = mod.poisson_trace(n_requests=6, models=[sim(m, 1e6, 1) for m in GW_MODELS],
                                  seed=seed, mean_interarrival=30.0)
        sink = gw.run_trace(trace)
        out.append(dict(cold=[(r.model_id, r.cold) for r in sink.records],
                        lifecycle=plain(gw.lifecycle.log), loads=eng.loads,
                        tokens=eng.tokens, host=eng.host_store.snapshot().as_dict()))
        eng.close()
    assert out[1] == out[0]
    assert {m for m, _ in out[0]["cold"]} == set(GW_MODELS)
    assert all(len(t) == 1 + GEN for _, t in out[0]["tokens"])
