"""Fine-tune variants sharing their base's tensors (DESIGN.md §17) on the
port's `Engine` against the reference's: `register_variant` records and
fingerprints, and the load ledgers under tests/test_dedup.py's call
sequences (a shared tensor admitted once and freed last, an active sharer
never evicted, random interleavings, the real-engine variant load).

Both engines get the reference's variant weights (its `register_variant`
perturbs with `jax.random`; the port's default draws from a seeded
`torch.Generator`), so logits compare too.  Within the port: a variant's
shared leaves are the base's tensors themselves, and the default
perturbation is deterministic and touches only delta leaves.  Where the
pool evicts, the reference engine gets the port engine's rule that frees
what the pool evicted (ROADMAP queue 3).
"""
import dataclasses
import random
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.allocator import AllocationError as RefAllocationError  # noqa: E402
from repro.models.tensors import VariantSpec as RefVariantSpec  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.allocator import AllocationError  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.tensors import FingerprintPolicy, VariantSpec, flatten_params  # noqa: E402
from repro_torch.serving.engine import Engine as PortEngine  # noqa: E402

from torch_port_helpers import (close_to, load_ledger, load_report, max_err,  # noqa: E402
                                paired_engines, ref_named_numpy)

DELTAS = {"v0": ("attn/wq",), "v1": ("attn/wq", "attn/wo"), "v2": ("mlp/wd",)}


class FreesEvictedRef(RefEngine):
    """The port engine's rule on the reference engine: what the pool
    evicted is freed after `load`, `release` and `finish_instance`, sparing
    models in use."""

    def load(self, model_id, **kw):
        rep = super().load(model_id, **kw)
        PortEngine.sync_evictions(self, keep_active=True)
        return rep

    def release(self, model_id):
        super().release(model_id)
        PortEngine.sync_evictions(self, keep_active=True)

    def finish_instance(self, model_id):
        super().finish_instance(model_id)
        PortEngine.sync_evictions(self, keep_active=True)

    def _drop_graphs(self, **which):
        """`sync_evictions` drops the port's captured steps with a params
        tree; the reference's compiled step holds no device pointers."""


def cfgs(layers=2):
    over = dict(num_layers=layers, vocab_size=512, dtype="float32")
    return (dataclasses.replace(ref_config("llama3.2-1b").smoke(), **over),
            dataclasses.replace(port_config("llama3.2-1b").smoke(), **over))


def variant_engines(cap=256 << 20, other=False):
    """Reference and port engines with a base, the three variants of
    `DELTAS` (the reference's perturbed weights in both) and, with `other`,
    an unrelated model of three layers."""
    rc, pc = cfgs()
    models = {"base": (rc, pc, 1)}
    if other:
        models["o"] = (*cfgs(3), 2)
    ref, port, _ = paired_engines(models, cap, ref_cls=FreesEvictedRef)
    for vid, delta in DELTAS.items():
        ref.register_variant(RefVariantSpec(vid, "base", delta))
        named = ref_named_numpy(ref.models[vid].init_fn())
        port.register_variant(VariantSpec(vid, "base", delta),
                              init_fn=lambda n=named: params_from_numpy(n, pc, device="cpu"))
    return ref, port


def records(eng, mid):
    return [(r.name, r.shape, r.dtype, r.fingerprint, r.nbytes) for r in eng.records_of(mid)]


def test_variant_records_and_fingerprints_match_reference():
    ref, port = variant_engines()
    base_fps = {r.fingerprint for r in port.records_of("base")}
    for mid in ("base", *DELTAS):
        assert records(port, mid) == records(ref, mid), mid
    for vid, delta in DELTAS.items():
        assert port.models[vid].spec.policy is FingerprintPolicy.CONTENT_BASE_HINT
        own = [r for r in port.records_of(vid) if r.fingerprint not in base_fps]
        assert own and all(any(d in r.name for d in delta) for r in own), vid
    ref.close(), port.close()


def _step(ref, port, op, mid) -> bool:
    """One call on both engines, then equal ledgers and sharer refcounts.
    Returns False for a load the pool cannot place beside the models in
    use (both engines must refuse it)."""
    if op == "load":
        try:
            rep = ref.load(mid)
        except RefAllocationError:
            with pytest.raises(AllocationError):
                port.load(mid)
            return False
        assert load_report(port.load(mid)) == load_report(rep), (op, mid)
        assert load_ledger(port) == load_ledger(ref), (op, mid)
    elif op == "release":
        ref.release(mid), port.release(mid)
    else:  # drop the model's claim (test_dedup.py's drop_model steps)
        ref.drop_device_copies(mid), port.drop_device_copies(mid)
    assert port.store.dedup_stats().as_dict() == ref.store.dedup_stats().as_dict(), (op, mid)
    assert port.store.dedup_stats().sharer_orphans == 0
    assert sorted(port.store.tensor_map) == sorted(ref.store.tensor_map)
    assert sorted(port._tensors) == sorted(ref._tensors)
    for m in port.store.active_models:  # an active model's leaves stay put
        assert all(r.fingerprint in port._tensors for r in port.records_of(m)), m
    return True


def _seeded_script(seed):
    rng = random.Random(seed)
    ops = ["load", "release", "drop"]
    return [(rng.choice(ops), rng.choice(["base", "v0", "v1", "o"])) for _ in range(24)]


SCRIPTS = {
    # test_dedup.py::test_shared_tensor_admitted_once_freed_last
    "admitted_once_freed_last": (None, [
        ("load", "base"), ("load", "v0"), ("release", "base"), ("drop", "base"),
        ("release", "v0"), ("drop", "v0"), ("load", "v1")]),
    # test_dedup.py::test_eviction_never_victimizes_active_sharers: a pool
    # that holds the base, one delta and part of another model
    "active_sharer_never_evicted": ("tight", [
        ("load", "base"), ("load", "v1"), ("release", "base"), ("load", "o"),
        ("release", "o"), ("release", "v1"), ("load", "v2"), ("load", "v0")]),
    # test_dedup.py::test_sharer_refcounts_survive_interleaving, seeded
    **{f"interleaving_{s}": ("tight", _seeded_script(s)) for s in (0, 1, 2)},
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_variant_load_ledgers_match_reference(name):
    pool, script = SCRIPTS[name]
    cap = 256 << 20
    if pool == "tight":
        probe, _ = variant_engines(other=True)
        size = {m: sum(r.nbytes for r in probe.records_of(m)) for m in probe.models}
        base_fps = {r.fingerprint for r in probe.records_of("base")}
        delta = sum(r.nbytes for r in probe.records_of("v1") if r.fingerprint not in base_fps)
        cap = size["base"] + delta + size["o"] // 2
        probe.close()
    ref, port = variant_engines(cap, other=True)
    loaded, refused = set(), 0
    for op, mid in script:
        if op == "load" or mid in loaded:  # release / drop what was loaded
            if _step(ref, port, op, mid):
                loaded.add(mid)
            else:
                refused += 1
    assert refused < len(script) // 2, refused
    ref.close(), port.close()


def test_real_engine_variant_load_moves_only_the_delta():
    """test_dedup.py::test_real_engine_satisfies_loadable_engine_and_variant_loads
    on both engines: the variant's cold load moves only its delta, its
    shared leaves are the base's tensors themselves (same storage), its
    logits equal the reference's and differ from the base's, and dropping
    it leaves the base resident."""
    ref, port = variant_engines()
    for mid in ("base", "v1"):
        assert load_report(port.load(mid)) == load_report(ref.load(mid)), mid
        assert load_ledger(port) == load_ledger(ref), mid
    full = sum(r.nbytes for r in port.records_of("v1"))
    assert 0 < port.last_load.bytes_h2d < full
    base_leaves = dict(flatten_params(port.params_of("base")))
    same = 0
    for name, leaf in flatten_params(port.params_of("v1")):
        shared = not any(d in name for d in DELTAS["v1"])
        assert (leaf is base_leaves[name]) == shared, name
        assert (leaf.data_ptr() == base_leaves[name].data_ptr()) == shared, name
        same += shared
    assert port.store.dedup_stats().shared_tensors == same
    toks = np.random.default_rng(0).integers(0, 512, (1, 12)).astype(np.int32)
    logits = {}
    for mid in ("base", "v1"):
        ri = ref.start_instance(mid, attn_mode="ref")
        pi = port.start_instance(mid)
        rl = ri.prefill({"tokens": jnp.asarray(toks)})
        pl = pi.prefill({"tokens": torch.from_numpy(toks)})
        assert close_to(pl, rl, "float32"), max_err(pl, rl)
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rl, pl = ri.decode(jnp.asarray(tok)), pi.decode(torch.from_numpy(tok))
        assert close_to(pl, rl, "float32"), max_err(pl, rl)
        logits[mid] = pl
        ri.finish(), pi.finish()
    assert max_err(logits["v1"], logits["base"]) > 1e-3
    _step(ref, port, "drop", "v1")
    assert load_report(port.load("base")) == load_report(ref.load("base"))
    assert port.last_load.bytes_h2d == 0
    ref.close(), port.close()


def test_default_perturbation_is_seeded_and_touches_only_delta_leaves():
    """Without an `init_fn` the port's variant is its base's tree with each
    delta leaf + 0.02 x a normal drawn from a generator on the engine's
    device (here the CPU) seeded by crc32(variant|leaf); shared leaves are
    the base tree's own tensors."""
    _, pc = cfgs()
    eng = PortEngine(256 << 20, device="cpu")
    eng.register("base", pc)
    base_tree = eng.models["base"].init_fn()
    eng.models["base"].init_fn = lambda: base_tree
    eng.register_variant(VariantSpec("v1", "base", DELTAS["v1"]))
    a = dict(flatten_params(eng.models["v1"].init_fn()))
    b = dict(flatten_params(eng.models["v1"].init_fn()))
    base = dict(flatten_params(base_tree))
    for name, leaf in a.items():
        assert torch.equal(leaf, b[name]), name
        if any(d in name for d in DELTAS["v1"]):
            seed = zlib.crc32(f"v1|{name}".encode()) & 0xFFFF
            noise = torch.randn(leaf.shape, dtype=leaf.dtype,
                                generator=torch.Generator(device="cpu").manual_seed(seed))
            assert torch.equal(leaf, base[name] + torch.tensor(0.02) * noise), name
            assert not torch.equal(leaf, base[name])
        else:
            assert leaf is base[name], name
    eng.close()
