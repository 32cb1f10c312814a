"""Elastic restore of sharded training state (`repro_torch.train.checkpoint`
with `shardings=`), on 4 gloo CPU ranks: llama3.2-1b's smoke config in fp32
takes one train step on a 2x2 (data, model) mesh, its parameters and AdamW
state are saved (each DTensor leaf written whole, by rank 0 only) and
restored onto a 1x4 mesh by the placements of that mesh's train step, and
one more step runs there.  Both losses equal the unsharded path's
(`launch.train.train_step` on plain tensors), every restored leaf carries
the requested mesh and placements, and the parameters after the second
step equal the unsharded ones."""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dist_helpers import finish, start_ranks  # noqa: E402

LOSS_TOL = 2e-5  # fp32 (test_torch_steps.py)
PARAM_TOL = 1e-6  # fp32 params after AdamW (test_torch_steps.py)


@pytest.fixture(scope="module")
def run():
    tmp = tempfile.mkdtemp(prefix="torch_elastic_")
    rng = np.random.default_rng(11)
    tokens = [rng.integers(0, 512, (4, 16)).astype(np.int32) for _ in range(2)]
    out = os.path.join(tmp, "out.pt")
    finish(start_ranks("elastic", 4, {"arch": "llama3.2-1b", "tokens": tokens,
                                      "dir": os.path.join(tmp, "ckpt")}, out), timeout=600)
    return torch.load(out, weights_only=False), tmp


def test_sharded_checkpoint_is_written_once_and_whole(run):
    _, tmp = run
    steps = os.listdir(os.path.join(tmp, "ckpt"))
    assert steps == ["step-00000001"], steps
    with np.load(os.path.join(tmp, "ckpt", steps[0], "tensors.npz")) as z:
        assert z["params/embed"].shape == (512, 128)  # the whole table, not a shard


def test_restore_onto_new_mesh_takes_requested_placements(run):
    got, _ = run
    assert got["wrong"] == []


def test_step_after_elastic_restore_equals_unsharded_path(run):
    got, _ = run
    for loss, plain in zip(got["losses"], got["plain"]):
        assert abs(loss - plain) <= LOSS_TOL, (got["losses"], got["plain"])
    errs = {n: float(np.max(np.abs(got["params"][n] - got["plain_params"][n])))
            for n in got["plain_params"]}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PARAM_TOL, (worst, errs[worst])
