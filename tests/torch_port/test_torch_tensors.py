"""Tensor records and the host/persistent stores of the port, held against
the reference: identical records (order, name, shape, dtype, nbytes,
fingerprint) for every architecture, and the same tier behaviour for the
same call sequence."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import all_configs as ref_configs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import tensors as RT  # noqa: E402
from repro_torch.configs import all_configs as port_configs  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import tensors as PT  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy  # noqa: E402

from torch_port_helpers import ref_named_numpy  # noqa: E402

ARCHS = sorted(ref_configs())


def rows(records):
    return [dataclasses.astuple(r) for r in records]


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_records_identical(name):
    ref = RT.spec_records(name, ref_configs()[name].smoke())
    port = PT.spec_records(name, port_configs()[name].smoke())
    assert rows(port) == rows(ref)


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-7b", "qwen3-moe-30b-a3b"])
def test_full_width_records_identical_without_materializing(name):
    """Records at the published widths, from shapes alone on both sides
    (jax.eval_shape / meta tensors)."""
    ref = RT.spec_records(name, ref_configs()[name])
    specs = port_build(port_configs()[name]).param_specs()
    assert all(t.is_meta for _, t in PT.flatten_params(specs))
    port = PT.tensor_records(name, specs)
    assert rows(port) == rows(ref)
    if name == "llama3.2-1b":  # 16 layers, d 2048, vocab 128256, tied
        assert sum(r.nbytes for r in port) == 2_471_763_968


def test_flatten_order_matches_jax_tree_leaves():
    cfg = ref_configs()["codeqwen1.5-7b"].smoke()
    named = ref_named_numpy(ref_build(cfg).init(jax.random.PRNGKey(0)))
    tree = params_from_numpy(named, port_configs()["codeqwen1.5-7b"].smoke(), device="cpu")
    assert [n for n, _ in PT.flatten_params(tree)] == list(named)
    rebuilt = PT.tree_unflatten(PT.tree_structure(tree),
                                [t for _, t in PT.flatten_params(tree)])
    assert [n for n, _ in PT.flatten_params(rebuilt)] == list(named)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_content_fingerprints_hash_the_same_bytes(dtype):
    cfg = dataclasses.replace(ref_configs()["llama3.2-1b"].smoke(), dtype=dtype)
    pcfg = dataclasses.replace(port_configs()["llama3.2-1b"].smoke(), dtype=dtype)
    params = ref_build(cfg).init(jax.random.PRNGKey(3))
    spec_r = RT.ModelSpec("m", policy="content")
    spec_p = PT.ModelSpec("m", policy="content")
    ref = RT.tensor_records(spec_r, params)
    port = PT.tensor_records(spec_p, params_from_numpy(ref_named_numpy(params), pcfg,
                                                              device="cpu"))
    assert rows(port) == rows(ref)
    # identical zero-initialised norms collide by construction (dedup)
    assert len({r.fingerprint for r in ref}) < len(ref)


def test_variant_base_hint_fingerprints_match():
    cfg = ref_configs()["llama3.2-1b"].smoke()
    vr = RT.VariantSpec("v1", "base", ("attn/wq",)).to_model_spec()
    vp = PT.VariantSpec("v1", "base", ("attn/wq",)).to_model_spec()
    ref = RT.spec_records(vr, cfg)
    port = PT.spec_records(vp, port_configs()["llama3.2-1b"].smoke())
    assert rows(port) == rows(ref)


def test_bf16_host_store_round_trip_through_persistent_tier():
    rng = np.random.default_rng(0)
    import ml_dtypes

    arr = rng.standard_normal((6, 10)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(arr)
    assert t.dtype == torch.bfloat16
    assert PT.content_fingerprint(t) == RT.content_fingerprint(arr)
    store = PT.HostTensorStore(capacity_bytes=None)
    assert store.put("fp", t)
    assert store.evict("fp") and "fp" not in store and "fp" in store.spill
    back = store.fetch("fp")
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == (6, 10)
    assert torch.equal(back, t)
    assert "fp" in store and "fp" not in store.spill
    store.evict("fp")
    store.spill.corrupt("fp")
    with pytest.raises(PT.StoreCorruptionError):
        store.fetch("fp")
    assert not store.resolvable("fp")  # quarantined


def _replay(mod, ops, cap, make):
    store = mod.HostTensorStore(capacity_bytes=cap)
    log = []
    for kind, fp, size in ops:
        if kind == "put":
            log.append(store.put(fp, make(fp, size)))
        elif kind == "fetch" and store.resolvable(fp):
            log.append(tuple(store.fetch(fp).shape))
        elif kind == "evict":
            log.append(store.evict(fp))
        elif kind == "pin":
            store.pin(fp)
        elif kind == "unpin":
            store.unpin(fp)
        elif kind == "cap":  # tenant pressure: the budget shrinks or grows
            log.append(store.set_capacity_bytes(size * 4))
        log.append((store.nbytes(), store.pinned_nbytes(), list(store._bufs),
                    len(store.spill)))
    return log, store.snapshot().as_dict()


@pytest.mark.parametrize("seed", range(4))
def test_host_store_tiers_match_reference_on_random_sequences(seed):
    """Same put/fetch/evict/pin/unpin/resize sequence -> same LRU order,
    byte counters, spill membership and snapshot in both packages."""
    rng = np.random.default_rng(seed)
    fps = [f"t{i}" for i in range(8)]
    kinds = ["put", "put", "fetch", "fetch", "evict", "pin", "unpin", "cap"]
    ops = [(kinds[rng.integers(len(kinds))], fps[rng.integers(len(fps))],
            int(rng.integers(1, 48))) for _ in range(150)]

    def content(fp, size):
        return ((np.arange(size) * (int(fp[1:]) + 3)) % 251).astype(np.uint8)

    ref = _replay(RT, ops, 160, content)
    port = _replay(PT, ops, 160, lambda fp, n: torch.from_numpy(content(fp, n)))
    assert port == ref
