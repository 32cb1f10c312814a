"""`repro_torch.roofline.analysis`: `CostCounter` against the analytic
per-chip counts of the reference's scanned-MLP test
(tests/test_roofline.py), the analytic model FLOPs against the reference's,
and the per-chip matmul FLOPs and collective bytes of every arch's train
step against the reference's HLO walker on the same cell (prefill and
decode: `test_torch_roofline_serve.py`).  The port's counts run in a subprocess that
joined a fake process group (shapes only); the reference's in one with
forced host devices."""
import json

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import SHAPES, all_configs  # noqa: E402
from repro.roofline import analysis as ref_roof  # noqa: E402
from repro_torch.configs import all_configs as port_configs  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402

from dist_helpers import run_snippet  # noqa: E402

MLP_SNIPPET = """
import json, torch
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(8)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.distributed.sharding import P, distribute
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.roofline.analysis import CostCounter

mesh = make_mesh_compat((2, 4), ("data", "model"))
D, F = 64, 256
out = {}
for L in (0, 3, 6):
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    h = distribute(meta(16, D), P("data", None), mesh)
    w1 = distribute(meta(L, D, F), P(None, None, "model"), mesh)
    w2 = distribute(meta(L, F, D), P(None, "model", None), mesh)
    counter = CostCounter()
    with counter, implicit_replication():
        for l in range(L):  # the reference's lax.scan body, layer by layer;
            # the row-parallel product reduced back to h's placement, as GSPMD
            # and the port's blocks (models.sharded.placed_like) place it
            h = (torch.tanh(h @ w1[l]) @ w2[l]).redistribute(mesh, h.placements)
        h.float().mean()
    out[L] = {"flops": counter.costs.flops, "coll": counter.costs.collective_bytes}
print("RESULT" + json.dumps(out))
"""


def test_counter_matches_analytic_mlp_and_scales_collectives():
    out = run_snippet(MLP_SNIPPET)
    assert "RESULT" in out.stdout, out.stderr[-3000:]
    data = {int(k): v for k, v in json.loads(out.stdout.split("RESULT")[1]).items()}
    L, D, F, B_loc, F_loc = 6, 64, 256, 16 // 2, 256 // 4
    assert data[6]["flops"] == L * 2 * (2 * B_loc * D * F_loc)
    tail = data[0]["coll"]
    assert data[3]["coll"] > tail
    assert data[6]["coll"] == 2 * (data[3]["coll"] - tail) + tail


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_model_flops_and_active_params_equal_reference(arch):
    cfg, pcfg = all_configs()[arch], port_configs()[arch]
    assert roof.active_params(pcfg) == ref_roof.active_params(cfg)
    for name, shape in SHAPES.items():
        assert roof.model_flops_for(pcfg, shape) == ref_roof.model_flops_for(cfg, shape), name


def test_moe_counts_active_experts_only():
    cfg = port_configs()["qwen3-moe-30b-a3b"]
    assert roof.active_params(cfg) < cfg.param_count() / 5


CELL_ARCHS = sorted(all_configs())


@pytest.fixture(scope="module")
def train_cell_flops():
    """Both packages' per-chip costs of every arch's train cell (see
    `walker_cells`), each package in its own subprocess, run together."""
    import walker_cells

    procs = [walker_cells.start(CELL_ARCHS, ["train_4k"], port) for port in (True, False)]
    return walker_cells.collect(procs[:1]), walker_cells.collect(procs[1:])


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_train_cell_flops_match_reference_walker(train_cell_flops, arch):
    """The smoke config's train_4k cut to S 256, B 8, on a 4x4 mesh: the
    port's per-chip matmul FLOPs within 10% of the reference walker's (the
    dense models to the FLOP; the MoE models' GShard dispatch and combine
    take the experts' sharding, as GSPMD gives them; Mamba2's scan runs on
    each rank's own heads) and its per-chip collective bytes at most 1.1x
    the walker's."""
    import walker_cells

    walker_cells.hold(*train_cell_flops, f"{arch}|train_4k")


@pytest.mark.parametrize("causal,window,pairs", [(True, 0, 10), (True, 2, 7), (False, 0, 16),
                                                  (False, 2, 13)])
def test_kernel_flop_formulas(causal, window, pairs):
    """The kernels' operators on meta tensors: output shapes from their
    fakes, nothing launched, and FLOPs (`torch.utils.flop_counter`) over the
    visible (query, key) pairs (S 4) or the tables' capacity (K1)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import visible_pairs

    assert visible_pairs(4, causal, window) == pairs
    before = ops.launch_counts()
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    with FlopCounterMode(display=False) as flash:
        out = ops.flash_attention(meta(2, 4, 8, 64), meta(2, 4, 2, 64), meta(2, 4, 2, 64),
                                  causal=causal, window=window)
    assert out.shape == (2, 4, 8, 64) and out.is_meta
    assert flash.get_total_flops() == 4 * 2 * 8 * 64 * pairs
    tables = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as paged:
        ops.paged_attention(meta(2, 8, 64), meta(16, 16, 2, 64), meta(16, 16, 2, 64), tables,
                            torch.empty((2,), dtype=torch.int32, device="meta"))
    assert paged.get_total_flops() == 4 * 2 * 8 * 64 * 3 * 16
    assert ops.launch_counts() == before
