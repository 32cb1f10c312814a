"""`repro_torch.distributed.compress` on 8 gloo ranks against the
reference's `compressed_grad_fn` on 8 fake devices (the reference's
tests/test_compress.py snippet), on the same numpy inputs."""
import os
import pickle
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dist_helpers import finish, start_ranks, start_snippet  # noqa: E402

WORLD = 8
REF_SNIPPET = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.compress import compressed_grad_fn
from repro.distributed.sharding import make_mesh_compat

with open(sys.argv[1], "rb") as f:
    data = pickle.load(f)
mesh = make_mesh_compat((8,), ("data",), devices=jax.devices())

def loss_fn(w, batch):
    pred = jnp.tanh(batch["x"] @ w["w1"]) @ w["w2"]
    return jnp.mean((pred - batch["y"]) ** 2)

params = jax.device_put({k: jnp.asarray(v) for k, v in data["params"].items()},
                        NamedSharding(mesh, P()))
batch = jax.device_put({k: jnp.asarray(v) for k, v in data["batch"].items()},
                       NamedSharding(mesh, P("data")))
residual = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
g_c, new_res, loss = jax.jit(compressed_grad_fn(loss_fn, mesh, ("data",)))(params, batch,
                                                                            residual)
g_exact = jax.jit(jax.grad(loss_fn))(params, batch)
with open(sys.argv[2], "wb") as f:
    pickle.dump({"grads": {k: np.asarray(v) for k, v in g_c.items()},
                 "exact": {k: np.asarray(v) for k, v in g_exact.items()},
                 "loss": float(loss)}, f)
"""


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    data = {"params": {"w1": (rng.standard_normal((16, 32)) * 0.3).astype(np.float32),
                       "w2": (rng.standard_normal((32, 4)) * 0.3).astype(np.float32)},
            "batch": {"x": rng.standard_normal((64, 16)).astype(np.float32),
                      "y": rng.standard_normal((64, 4)).astype(np.float32)}}
    tmp = tempfile.mkdtemp(prefix="torch_compress_")
    paths = [os.path.join(tmp, n) for n in ("in.pkl", "ref.pkl", "port.pt")]
    with open(paths[0], "wb") as f:
        pickle.dump(data, f)
    ref = start_snippet(f"import sys\nsys.argv = ['ref', {paths[0]!r}, {paths[1]!r}]\n"
                        + REF_SNIPPET, {"JAX_PLATFORMS": "cpu"})
    port = start_ranks("compress", WORLD, {**data, "world": WORLD}, paths[2])
    finish(ref, timeout=600)
    finish(port, timeout=600)
    with open(paths[1], "rb") as f:
        return pickle.load(f), torch.load(paths[2], weights_only=False)


def test_compressed_grads_close_to_exact(runs):
    ref, port = runs
    rel = max(float(np.max(np.abs(port["grads"][k] - ref["exact"][k]))
                    / (np.max(np.abs(ref["exact"][k])) + 1e-9)) for k in ref["exact"])
    assert rel < 0.02, rel  # the reference's bound (tests/test_compress.py)
    assert abs(port["loss"] - ref["loss"]) <= 2e-5


def test_error_feedback_residual_nonzero(runs):
    assert runs[1]["residual_norm"] > 0


def test_within_one_quantization_step_of_reference(runs):
    ref, port = runs
    for k, want in ref["grads"].items():
        assert float(np.max(np.abs(port["grads"][k] - want))) <= port["step"][k], k


def test_wire_traffic_is_int8(runs):
    """Every gradient-sized collective is an int8 all-gather; no fp32
    all-reduce moves a gradient (only the 0-d loss is all-reduced)."""
    _, port = runs
    record = port["record"]
    grads = {(1, 16, 32), (1, 32, 4)}
    sized = [r for r in record if tuple(r[2]) in grads]
    assert len(sized) == 2 and all(r[0] == "all_gather_into_tensor" and r[1] == "torch.int8"
                                   for r in sized), record
    assert all(not (r[0].startswith("all_reduce") and len(r[2]) > 0) for r in record), record
