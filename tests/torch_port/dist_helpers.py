"""Run the port on several CPU ranks for the distributed tests.

A default process group must not live in the pytest process (xdist hands
one worker several test files), so every distributed check runs in a
subprocess: `spawn` starts ``python dist_helpers.py``, which spawns `world`
gloo ranks (`torch.multiprocessing`, the spawn method) running one of the
`WORKERS` below on the inputs the test wrote; rank 0 saves the results.
Tests that need a fake process group (shapes only) run a snippet that
joins one (`run_snippet`).  The reference's multi-device numbers come from
their own subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (the tests' own
snippets), as the reference's tests get theirs.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(Path(__file__).parent)])}


def run_snippet(code: str, timeout: int = 300, env_extra=None) -> subprocess.CompletedProcess:
    """`python -c code` with the repository's packages importable."""
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env={**ENV, **(env_extra or {})})


def start_snippet(code: str, env_extra=None) -> subprocess.Popen:
    """`python -c code`, started (for tests that run two subprocesses at once)."""
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={**ENV, **(env_extra or {})})


def finish(proc: subprocess.Popen, timeout: int = 300) -> tuple[str, str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out, err


def start_ranks(worker: str, world: int, inputs: dict, out_path: str) -> subprocess.Popen:
    """Start `world` gloo ranks running `WORKERS[worker]` on `inputs`
    (saved with `torch.save`); rank 0 saves its results to `out_path`."""
    import torch

    in_path = out_path + ".in"
    torch.save(inputs, in_path)
    code = ("import dist_helpers\n"
            f"dist_helpers.launch({worker!r}, {world}, {in_path!r}, {out_path!r})\n")
    return start_snippet(code)


def launch(worker: str, world: int, in_path: str, out_path: str):
    import torch.multiprocessing as mp

    init = tempfile.mktemp(prefix="gloo_init_")
    mp.spawn(_rank_main, args=(worker, world, init, in_path, out_path), nprocs=world)


def _rank_main(rank: int, worker: str, world: int, init: str, in_path: str, out_path: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = WORKERS[worker](rank, inputs)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- workers
def _full(t):
    """A DTensor's whole value (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _named(tree) -> dict:
    from repro_torch.models.tensors import flatten_params

    return {n: _full(t).detach().float().numpy() for n, t in flatten_params(tree)}


def _port_cfg(case):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(case["arch"]).smoke(), dtype="float32")
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, num_heads=case["heads"][0], num_kv_heads=case["heads"][1])
    return cfg


def _tree_like(template, named: dict):
    import torch

    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten

    return tree_unflatten(tree_structure(template),
                          [tensor_from_numpy(named[n]).clone() for n, _ in flatten_params(template)])


KV_LEAVES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v")


def steps_worker(rank: int, inputs: dict) -> dict:
    """Each case's port step on its mesh (see test_torch_steps.py)."""
    import torch

    from torch.distributed.tensor import Shard

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, sharded
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.tensors import flatten_params
    from repro_torch.train.optimizer import init_opt_state

    placed = []
    real_ep = sharded.expert_parallel

    def recording_ep(t, axis):
        out = real_ep(t, axis)
        placed.append(tuple(repr(p) for p in out.placements))
        return out

    sharded.expert_parallel = recording_ep
    results = {}
    for case in inputs["cases"]:
        name, kind = case["name"], case["kind"]
        cfg = _port_cfg(case)
        model = build_model(cfg)
        mesh = make_local_mesh(tuple(case["mesh"]), device_type="cpu")
        params = params_from_numpy(inputs["params"][name], cfg, device="cpu")
        data = inputs["data"][name]
        shape = ShapeConfig(kind, case["S"], case["B"], "decode" if kind == "serve" else kind)
        out = {}
        if kind == "train":
            b = steps.make_train_step(cfg, mesh, shape, microbatches=case.get("mb", 1),
                                      moe_ep_axis=case.get("ep", ""))
            placed.clear()
            args = b.place(params, init_opt_state(params), {"tokens": torch.from_numpy(data["tokens"])})
            new_params, _, loss = b.fn(*args)
            out = {"loss": float(_full(loss)), "params": _named(new_params),
                   "ep_placements": sorted(set(placed))}
        elif kind == "prefill":
            b = steps.make_prefill_step(cfg, mesh, shape)
            args = b.place(params, {"tokens": torch.from_numpy(data["tokens"])})
            last, cache = b.fn(*args)
            out = {"last": _full(last).numpy(), "cache": _named(cache)}
            logits, plain_cache = model.prefill(params, {"tokens": torch.from_numpy(data["tokens"])},
                                                cache_cap=case["S"])
            out["unsharded_last"] = logits[:, -1].numpy()
        else:
            b = steps.make_serve_step(cfg, mesh, shape)
            cache = _tree_like(model.input_specs(shape)["cache"], data["cache"])
            args = b.place(params, torch.from_numpy(data["token"]), torch.from_numpy(data["pos"]),
                           cache)
            logits, new_cache = b.fn(*args)
            out = {"logits": _full(logits).numpy(), "cache": _named(new_cache),
                   # the k / v leaves (..., B, C, K, hd) whose slots shard
                   "seq_sharded": [n for n, t in flatten_params(args[3])
                                   if n.rsplit("/", 1)[-1] in KV_LEAVES
                                   and Shard(t.ndim - 3) in t.placements]}
        results[name] = out
    sharded.expert_parallel = real_ep
    return results


def compress_worker(rank: int, inputs: dict) -> dict:
    """`compressed_grad_fn` over every rank on the "data" axis, under a
    dispatch-mode record of the collectives (see test_torch_compress.py)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.distributed.compress import compressed_grad_fn, quantize_int8, residual_like
    from repro_torch.launch.mesh import make_local_mesh

    world = inputs["world"]
    mesh = make_local_mesh((world,), ("data",), device_type="cpu")
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}

    def loss_fn(w, b):
        return ((torch.tanh(b["x"] @ w["w1"]) @ w["w2"] - b["y"]) ** 2).mean()

    record = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns, _, name = func._schema.name.partition("::")
            if ns == "_c10d_functional" and name != "wait_tensor" and args:
                record.append((name, str(args[0].dtype), tuple(args[0].shape)))
            return func(*args, **(kwargs or {}))

    with Record():
        grads, residual, loss = compressed_grad_fn(loss_fn, mesh, ("data",))(
            params, batch, residual_like(params))
    # one quantization step of each leaf: the largest of the ranks' scales
    # (each rank's rows, as the step chunked them)
    steps_ = {}
    for k in params:
        p = {n: v.clone().requires_grad_() for n, v in params.items()}
        local = {n: v.chunk(world)[rank] for n, v in batch.items()}
        g = torch.autograd.grad(loss_fn(p, local), [p[k]])[0]
        steps_[k] = float(quantize_int8(g)[1])
    gathered = [None] * world
    import torch.distributed as dist

    dist.all_gather_object(gathered, steps_)
    return {"grads": {k: v.numpy() for k, v in grads.items()},
            "residual_norm": float(sum(r.abs().sum() for r in residual.values())),
            "loss": float(loss), "record": record,
            "step": {k: max(s[k] for s in gathered) for k in params}}


def elastic_worker(rank: int, inputs: dict) -> dict:
    """One train step on a 2x2 mesh, its state saved (DTensor leaves written
    whole by rank 0), restored onto a 1x4 mesh by the new step's specs, one
    more step there; and the same two steps unsharded (see
    test_torch_elastic.py)."""
    import copy

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_step
    from repro_torch.models import build_model
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
    from repro_torch.train.checkpoint import restore, save
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = _port_cfg({"arch": inputs["arch"]})
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = [{"tokens": torch.from_numpy(t)} for t in inputs["tokens"]]
    B, S = inputs["tokens"][0].shape
    shape = ShapeConfig("train", S, B, "train")

    # the unsharded path first: the sharded steps update their shards in place
    plain_p, plain_o, plain = copy.deepcopy(params), init_opt_state(params), []
    for batch in tokens:
        plain_p, plain_o, loss, _ = train_step(model, plain_p, plain_o, batch, AdamWConfig())
        plain.append(float(loss))

    first = steps.make_train_step(cfg, make_local_mesh((2, 2), device_type="cpu"), shape)
    p1, o1, loss1 = first.fn(*first.place(params, init_opt_state(params), tokens[0]))
    save(inputs["dir"], 1, {"params": p1, "opt": o1})
    dist.barrier()  # rank 0 wrote it

    mesh = make_local_mesh((1, 4), device_type="cpu")
    second = steps.make_train_step(cfg, mesh, shape)
    saved = {"params": p1, "opt": o1}
    pairs = {k: [(mesh, shd.placements(s, mesh)) for s in shd.spec_leaves(spec)]
             for k, spec in (("params", second.specs[0]), ("opt", second.specs[1]))}
    state = restore(inputs["dir"], saved, shardings={
        k: tree_unflatten(tree_structure(saved[k]), pairs[k]) for k in pairs})
    wrong = [f"{k}/{n}" for k in pairs
             for (n, t), (m, pl) in zip(flatten_params(state[k]), pairs[k])
             if t.device_mesh is not m or tuple(t.placements) != pl]
    p2, _, loss2 = second.fn(state["params"], state["opt"],
                             shd.distribute(tokens[1], second.specs[2], mesh))
    return {"losses": [float(_full(loss1)), float(_full(loss2))], "plain": plain,
            "params": _named(p2), "plain_params": _named(plain_p), "wrong": wrong}


WORKERS = {"steps": steps_worker, "compress": compress_worker, "elastic": elastic_worker}


if __name__ == "__main__":
    launch(*sys.argv[1:2], int(sys.argv[2]), *sys.argv[3:5])
