"""The sharding rules (`repro_torch.distributed.sharding`) against the
reference's, entry for entry, and the DTensor placements they give against
JAX's device-to-slice maps.  No process group: the rules and placements
read only a mesh's axis names and sizes (stand-in meshes), and the meshes'
builders must raise without enough ranks."""
import json
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import SHAPES, all_configs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.tensors import leaf_path  # noqa: E402
from repro_torch.configs import all_configs as port_configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.tensors import flatten_params  # noqa: E402

from dist_helpers import run_snippet  # noqa: E402


def _ref_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _ref_leaves(tree) -> dict:
    return {leaf_path(p): tuple(l.shape) for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_param_spec_equals_reference_for_every_leaf(arch):
    cfg, pcfg = all_configs()[arch], port_configs()[arch]
    ref = _ref_leaves(jax.eval_shape(lambda k: ref_build(cfg).init(k), jax.random.PRNGKey(0)))
    port = {n: tuple(t.shape) for n, t in flatten_params(build_model(pcfg).param_specs())}
    assert port == ref
    for tp in (1, 2, 4, 8, 16):
        for name, shape in ref.items():
            want = _ref_tuple(ref_shd.param_spec(name, shape, cfg, tp))
            assert tuple(shd.param_spec(name, shape, pcfg, tp)) == want, (name, tp)


def test_reference_spec_cases():
    """tests/test_distributed.py's four cases, on the port's rules."""
    cfgs = port_configs()
    yi, qv = cfgs["yi-9b"], cfgs["qwen2-vl-7b"]
    assert shd.param_spec("segments/0/0/attn/wq", (48, 4096, 32, 128), yi, 16) == \
        (None, None, "model", None)
    assert shd.param_spec("segments/0/0/attn/wk", (48, 4096, 4, 128), yi, 16) == (None,) * 4
    assert shd.param_spec("segments/0/0/attn/wq", (28, 3584, 28, 128), qv, 16) == \
        (None, None, None, "model")
    mx = cfgs["mixtral-8x7b"]
    assert shd.param_spec("segments/0/0/mlp/wd", (32, 8, 14336, 4096), mx, 16) == \
        (None, None, "model", None)
    assert shd.param_spec("embed", (102400, 4096), cfgs["deepseek-7b"], 16) == ("model", None)


class RefMesh:
    def __init__(self, axes, shape):
        import numpy as np

        self.axis_names, self.devices = axes, np.zeros(shape)


MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_cache_pspecs_equal_reference(arch, shape_name, mesh_kind):
    axes, sizes = MESHES[mesh_kind]
    cfg, pcfg, shape = all_configs()[arch], port_configs()[arch], SHAPES[shape_name]
    ref_cache = ref_build(cfg).input_specs(shape)["cache"]
    port_cache = build_model(pcfg).input_specs(shape)["cache"]
    stand_in = types.SimpleNamespace(mesh_dim_names=axes, shape=sizes)
    for seq_shard in (False, True):
        ref = jax.tree_util.tree_flatten_with_path(
            ref_shd.cache_pspecs(cfg, ref_cache, RefMesh(axes, sizes), batch=shape.global_batch,
                                 seq_shard=seq_shard), is_leaf=lambda x: isinstance(x, JP))[0]
        port = shd.spec_leaves(shd.cache_pspecs(pcfg, port_cache, stand_in,
                                                batch=shape.global_batch, seq_shard=seq_shard))
        names = [n for n, _ in flatten_params(port_cache)]
        assert names == [leaf_path(p) for p, _ in ref]
        assert [tuple(s) for s in port] == [_ref_tuple(s) for _, s in ref]


SLICES_SNIPPET = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import itertools, json
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.sharding import make_mesh_compat

CASES = json.loads('''{cases}''')
out = []
for axes, shape, spec, tshape in CASES:
    mesh = make_mesh_compat(tuple(shape), tuple(axes), devices=jax.devices())
    entries = [tuple(e) if isinstance(e, list) else e for e in spec]
    imap = NamedSharding(mesh, P(*entries)).devices_indices_map(tuple(tshape))
    rows = []
    for coord in itertools.product(*[range(n) for n in shape]):
        dev = mesh.devices[coord]
        rows.append([[s.start or 0, tshape[i] if s.stop is None else s.stop]
                     for i, s in enumerate(imap[dev])])
    out.append(rows)
print("RESULT" + json.dumps(out))
"""

SLICE_CASES = [
    (["data", "model"], [2, 4], ["data", "model"], [8, 16]),
    (["data", "model"], [2, 4], [None, None], [8, 16]),
    (["pod", "data", "model"], [2, 2, 2], [["pod", "data"], None], [8, 6]),
    (["pod", "data", "model"], [2, 2, 2], ["data", "model"], [4, 8]),
    (["pod", "data", "model"], [2, 2, 2], [None, None, None], [2, 4, 6]),
]


def test_placements_slice_like_jax():
    """Each rank's slice under `placements(spec)` equals the slice JAX's
    `NamedSharding.devices_indices_map` gives the device at the same mesh
    coordinate."""
    import itertools

    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    out = run_snippet(SLICES_SNIPPET.replace("{cases}", json.dumps(SLICE_CASES)),
                      env_extra={"JAX_PLATFORMS": "cpu"})
    assert "RESULT" in out.stdout, out.stderr[-2000:]
    want = json.loads(out.stdout.split("RESULT")[1])
    for (axes, sizes, spec, tshape), rows in zip(SLICE_CASES, want):
        stand_in = types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(sizes))
        pl = shd.placements(shd.P(*[tuple(e) if isinstance(e, list) else e for e in spec]),
                            stand_in)
        got = []
        for coord in itertools.product(*[range(n) for n in sizes]):
            local, offset = _compute_local_shape_and_global_offset(
                tuple(tshape), tuple(sizes), list(coord), pl)
            got.append([[o, o + n] for o, n in zip(offset, local)])
        assert got == rows, (axes, spec)


def test_mesh_builders_raise_without_enough_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    for build in (lambda: port_mesh.make_production_mesh(),
                  lambda: port_mesh.make_production_mesh(multi_pod=True),
                  lambda: port_mesh.make_local_mesh((2, 2), device_type="cpu")):
        with pytest.raises(RuntimeError, match="ranks"):
            build()
    with pytest.raises(RuntimeError, match="fake process group"):
        port_mesh.make_production_mesh()
