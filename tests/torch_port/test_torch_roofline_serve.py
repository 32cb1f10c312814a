"""The per-chip costs of every arch's prefill and decode steps against the
reference's HLO walker (`walker_cells`: smoke configs, prefill_32k and
decode_32k cut to S 1024, B 8, on a 4x4 (data, model) mesh).  Each case
holds the port's matmul FLOPs within 10% of the walker's, attention
reckoned alike (K2's skipped pairs added back), and its collective bytes
at most 1.1x the walker's.  The decode cells run the flash-decode combine
over the sequence-sharded cache (`models.sharded.flash_decode`)."""
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from repro.configs import all_configs  # noqa: E402

import walker_cells  # noqa: E402

ARCHS = sorted(all_configs())
SHAPES = ["prefill_32k", "decode_32k"]


@pytest.fixture(scope="module")
def serve_cells():
    procs = [walker_cells.start(ARCHS, SHAPES, port) for port in (True, False)]
    return walker_cells.collect(procs[:1]), walker_cells.collect(procs[1:])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_costs_match_reference_walker(serve_cells, arch, shape):
    walker_cells.hold(*serve_cells, f"{arch}|{shape}")


def test_flash_decode_moves_kilobytes_not_the_cache(serve_cells):
    """llama3.2-1b's decode over a sequence-sharded cache reduces softmax
    statistics, not the cache: at most the walker's 24,888 B a chip x 1.1
    (it gathered the cache whole, 1,064,448 B, before the combine)."""
    port, ref = serve_cells
    got = port["llama3.2-1b|decode_32k"]
    assert got["coll"] <= 1.1 * ref["llama3.2-1b|decode_32k"]["coll"]
    assert got["collectives"].get("all-gather", 0) < 4096, got["collectives"]
