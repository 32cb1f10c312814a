"""The port's serving engine against the reference engine, both on the CPU
and over the same exported weights: identical load ledgers across the three
tiers, identical ElasticKV block tables and table uploads through a
mixed-length prefill and decode, and decode logits within tolerance.  Within
the port: paged decode equals ring decode, fused `decode_many` and the legacy
step equal the per-instance fast step bit for bit.

The reference engine decodes with attn_mode="ref" (its jitted oracle, which
tests/test_kernels.py pins to its Pallas kernel); CPU tensors run the port's
plain versions.  Model weights are fp32 so logits compare at 1e-4.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.serving.engine import ChunkedTransfer, DataLoadStats  # noqa: E402
from repro_torch.serving.engine import Engine as PortEngine  # noqa: E402

from torch_port_helpers import load_ledger as ledger  # noqa: E402
from torch_port_helpers import load_report as report  # noqa: E402
from torch_port_helpers import max_err, paired_engines  # noqa: E402

LOGIT_TOL = 1e-4  # fp32: the same math summed in another order


def cfgs(layers=2, dtype="float32", name="llama3.2-1b"):
    over = dict(num_layers=layers, vocab_size=512, dtype=dtype)
    return (dataclasses.replace(ref_config(name).smoke(), **over),
            dataclasses.replace(port_config(name).smoke(), **over))


def engines(models, cap=64 << 20, **kw):
    """A reference and a port engine with the same models registered over
    the same weights.  `models`: {model_id: (ref_cfg, port_cfg, seed)}."""
    ref, port, _ = paired_engines(models, cap, **kw)
    return ref, port


SCENARIOS = {
    # cold load, warm reload, then a second model over a tight pool evicts
    # parts of the first (test_engine.py::test_load_reuse_and_eviction_sync)
    "reuse_then_evict": dict(cap=8 << 20, steps=[
        ("load", "a"), ("release", "a"), ("load", "a"), ("release", "a"),
        ("load", "b"), ("sync", None), ("release", "b"), ("load", "a")]),
    # host cap 0: release spills to the persistent tier; a dropped model
    # reloads from the store, then hot from the device pool
    "three_tier": dict(cap=64 << 20, host_cache_bytes=0, steps=[
        ("load", "a"), ("drop", "a"), ("load", "a"), ("load", "a"),
        ("load", "b"), ("drop", "b"), ("drop", "a"), ("load", "b")]),
    # a host cap below one model: the LRU tail spills, the next load splits
    # host and store bytes (test_fastpath.py::test_partial_spill...)
    "partial_spill": dict(cap=64 << 20, host_cache_bytes=600_000, steps=[
        ("load", "a"), ("drop", "a"), ("load", "a"), ("release", "a"),
        ("load", "b"), ("drop", "b"), ("load", "b")]),
    # a placement hint promotes a spilled model before its load joins it;
    # an abandoned hint is cancelled; retain keeps a released model pinned
    "prefetch_and_retain": dict(cap=64 << 20, host_cache_bytes=0, steps=[
        ("load", "a"), ("drop", "a"), ("prefetch", "a"), ("load", "a"),
        ("load", "b"), ("drop", "b"), ("prefetch", "b"), ("cancel", "b"),
        ("load", "b"), ("release", "b"), ("retain", "b"), ("drop", "a"),
        ("load", "a")]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_load_ledgers_identical_to_reference(scenario):
    spec = dict(SCENARIOS[scenario])
    steps = spec.pop("steps")
    ra, pa = cfgs(2)
    rb, pb = cfgs(3)
    ref, port = engines({"a": (ra, pa, 1), "b": (rb, pb, 2)},
                        chunk_bytes=16 << 10, **spec)
    chunked = False
    for op, mid in steps:
        if op == "load":
            r1, r2 = ref.load(mid), port.load(mid)
            assert report(r2) == report(r1), (op, mid)
            assert ledger(port) == ledger(ref), (op, mid)
            chunked |= port.last_load.chunks_h2d > port.last_load.tensors_h2d
        elif op == "release":
            ref.release(mid), port.release(mid)
        elif op == "drop":
            ref.drop_device_copies(mid), port.drop_device_copies(mid)
        elif op == "prefetch":  # wait for the promotion: deterministic join
            ref.prefetch(mid).done.wait(10), port.prefetch(mid).done.wait(10)
        elif op == "cancel":
            ref.cancel_prefetch(mid), port.cancel_prefetch(mid)
        elif op == "retain":
            ref.retain(mid), port.retain(mid)
        else:
            ref.sync_evictions(), port.sync_evictions()
        assert port._host_pins == ref._host_pins, (op, mid)
        assert sorted(port._params_cache) == sorted(ref._params_cache)
    assert chunked  # the small chunk size split tensors into several chunks
    ref.close(), port.close()


def test_chunked_transfer_round_trip_and_chunk_count():
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    tiny = torch.from_numpy(rng.standard_normal((3,)).astype(np.float32))
    stats = DataLoadStats()
    out = ChunkedTransfer(device="cpu", chunk_bytes=16 * 1024, depth=2).transfer(
        [("big", big), ("tiny", tiny)], stats)
    assert torch.equal(out["big"], big) and torch.equal(out["tiny"], tiny)
    assert out["big"].data_ptr() != big.data_ptr()  # a copy, as on a device
    assert (stats.tensors_h2d, stats.bytes_h2d) == (2, big.nbytes + tiny.nbytes)
    assert stats.chunks_h2d == -(-big.nbytes // (16 * 1024)) + 1


def prefill_both(ref, port, B, S, lens, seed=0, attn=("ref", "kernel")):
    ri = ref.start_instance("m", num_pages=64, attn_mode=attn[0])
    pi = port.start_instance("m", num_pages=64, attn_mode=attn[1])
    toks = np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)
    rl = ri.prefill({"tokens": jnp.asarray(toks)}, lengths=lens)
    pl = pi.prefill({"tokens": torch.from_numpy(toks)}, lengths=lens)
    return ri, pi, rl, pl


def test_block_tables_and_logits_track_reference_through_decode():
    rc, pc = cfgs(2)
    ref, port = engines({"m": (rc, pc, 3)})
    ref.load("m"), port.load("m")
    ri, pi, rl, pl = prefill_both(ref, port, 3, 32, [32, 17, 25])
    assert max_err(pl, rl) < LOGIT_TOL
    assert np.array_equal(pi._tables_np, ri._tables_np)
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    for step in range(20):  # crosses block boundaries (T=16) for every row
        rl = ri.decode(jnp.asarray(tok))
        pl = pi.decode(torch.from_numpy(tok))
        assert np.array_equal(pi._tables_np, ri._tables_np), step
        assert pi.table_uploads == ri.table_uploads, step
        assert np.array_equal(pi._host_lens, ri._host_lens)
        assert max_err(pl, rl) < LOGIT_TOL, step
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    assert 0 < pi.table_uploads < 10
    free_ref, free_port = ref.store.free_bytes(), port.store.free_bytes()
    ri.finish(), pi.finish()
    assert port.store.free_bytes() == ref.store.free_bytes() > free_port == free_ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_ring_decode(dtype):
    """test_engine.py::test_paged_decode_matches_ring_decode for the port:
    the engine's paged decode against the model's ring-cache decode."""
    _, pc = cfgs(2, dtype, name="deepseek-7b")
    eng = PortEngine(256 << 20, device="cpu")
    eng.register("m", pc)
    eng.load("m")
    inst = eng.start_instance("m", num_pages=64)
    model = port_build(pc)
    B, S = 2, 48
    batch = {"tokens": torch.randint(0, 512, (B, S), generator=torch.Generator().manual_seed(3),
                                     dtype=torch.int32)}
    logits = inst.prefill(batch)
    params = eng.params_of("m")
    _, ring = model.prefill(params, batch, cache_cap=64)
    tok = logits.argmax(-1).to(torch.int32)
    tol = LOGIT_TOL if dtype == "float32" else 5e-2  # test_engine.py's bf16 bound
    for i in range(3):
        ring_logits, ring = model.decode(params, tok, torch.full((B,), S + i, dtype=torch.int32),
                                         ring)
        paged = inst.decode(tok)
        assert max_err(paged, ring_logits) < tol, i
        tok = paged.argmax(-1).to(torch.int32)
    inst.finish()


def run_port(fused: bool, legacy: bool = False, steps: int = 6):
    _, pc = cfgs(2)
    eng = PortEngine(256 << 20, device="cpu")
    eng.register("m", pc)
    eng.load("m")
    gen = torch.Generator().manual_seed(11)
    ba = {"tokens": torch.randint(0, 512, (2, 24), generator=gen, dtype=torch.int32)}
    bb = {"tokens": torch.randint(0, 512, (2, 24), generator=gen, dtype=torch.int32)}
    ia = eng.start_instance("m", num_pages=64)
    ib = eng.start_instance("m", num_pages=64)
    ta = ia.prefill(ba).argmax(-1).to(torch.int32)
    tb = ib.prefill(bb).argmax(-1).to(torch.int32)
    outs = []
    for _ in range(steps):
        if fused:
            oa, ob = eng.decode_many([(ia, ta), (ib, tb)])
        elif legacy:
            oa, ob = ia.decode_legacy(ta), ib.decode_legacy(tb)
        else:
            oa, ob = ia.decode(ta), ib.decode(tb)
        outs.append((oa, ob))
        ta, tb = oa.argmax(-1).to(torch.int32), ob.argmax(-1).to(torch.int32)
    assert ia.slab is ib.slab
    pages_a = {p for t in ia.kv.block_tables.values() for p in ia._pages(t)}
    pages_b = {p for t in ib.kv.block_tables.values() for p in ib._pages(t)}
    assert pages_a and pages_b and not (pages_a & pages_b)  # interleaved, disjoint
    ia.finish()
    assert "m" in eng.store.active_models  # ib still live
    ib.finish()
    assert "m" not in eng.store.active_models
    return outs


@pytest.fixture(scope="module")
def per_instance_decode():
    return run_port(fused=False, steps=18)  # crosses a block boundary


@pytest.mark.parametrize("other", ["fused", "legacy"])
def test_decode_variants_bitwise_equal_within_port(other, per_instance_decode):
    base = per_instance_decode
    alt = run_port(fused=other == "fused", legacy=other == "legacy", steps=18)
    for (a1, b1), (a2, b2) in zip(base, alt):
        assert torch.equal(a1, a2) and torch.equal(b1, b2)


def test_cuda_engine_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEngine(1 << 20)  # device="cuda" is the default


HOST_READS = ("item", "tolist", "numpy", "cpu", "__int__", "__float__", "__bool__",
              "__index__", "__array__")


def forbid_host_reads(monkeypatch):
    """Make every Tensor method that copies device data to the host raise:
    on a card each of these is a synchronizing device->host transfer."""
    def refuse(*_a, **_k):
        raise RuntimeError("host read of a tensor")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)


def mixed_length_instance():
    _, pc = cfgs(2)
    eng = PortEngine(256 << 20, device="cpu")
    eng.register("m", pc)
    eng.load("m")
    inst = eng.start_instance("m", num_pages=64)
    toks = torch.randint(0, 512, (3, 32), generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    logits = inst.prefill({"tokens": toks}, lengths=[32, 17, 25])
    return inst, logits.argmax(-1).to(torch.int32)


def test_decode_reads_nothing_back_from_the_device(monkeypatch):
    """The test_fastpath.py sync-free checks for the port: 20 steps, block
    boundaries included, with every tensor->host read refused."""
    inst, tok = mixed_length_instance()
    forbid_host_reads(monkeypatch)
    for _ in range(20):
        tok = inst.decode(tok).argmax(-1).to(torch.int32)
    monkeypatch.undo()
    assert inst.table_uploads > 0
    inst.finish()


def test_legacy_decode_is_caught_reading_back(monkeypatch):
    """The detector detects: the legacy step's length read fails it."""
    inst, tok = mixed_length_instance()
    forbid_host_reads(monkeypatch)
    with pytest.raises(RuntimeError, match="host read"):
        inst.decode_legacy(tok)
