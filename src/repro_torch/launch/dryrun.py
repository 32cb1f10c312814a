"""Multi-pod dry-run (port of `repro/launch/dryrun.py`): trace every
(architecture x input-shape) cell on the production meshes and extract
the roofline terms.

  single-pod mesh (16, 16)    = 256 ranks  ("data", "model")   -> roofline rows
  multi-pod mesh (2, 16, 16)  = 512 ranks  ("pod", "data", "model") -> proves
                                            the pod axis shards

The process first joins a fake process group of 512 ranks as rank 0 (the
reference forces 512 host devices at the same point): meshes, DTensor
placements and collectives then behave as on the production mesh, and no
collective moves data.  Each cell builds its step (`distributed.steps`),
places its parameters and inputs by their partition specs as DTensors on
a CUDA mesh whose local shards are ``meta`` tensors (shapes only: no
memory, no card), and runs the step once under
`roofline.analysis.CostCounter`, which counts rank 0's per-chip matmul
FLOPs, bytes and collective bytes.  The kernels' operators take meta
tensors through their fakes, as the card's path takes them.  (Fake CUDA
tensors under `FakeTensorMode` would do the same on PyTorch built with
CUDA; on a CPU-only build their Python indexing asks for a CUDA device
guard that build lacks, so the dry-run uses meta shards on both.)

`memory_analysis` gives the argument and output bytes of rank 0's shards;
`temp_bytes` is null: over meta shards `MemTracker`'s peak is not credible
(for llama3.2-1b's train_4k it read more on the multi-pod mesh than on the
single pod, though the batch shard there is half the size), and
`alias_bytes` has no counterpart without buffer donation.  `trace_s`
replaces the reference's `lower_s` / `compile_s` (kept as null: there is no
compile step).

Results are written incrementally to dryrun_results_torch.json at the
repository root (never to the reference's dryrun_results.json); cells
already present are skipped unless --force.  One process holds one default
process group, so the dry-run always runs as its own process:

  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, all_configs, runnable_cells, skipped_cells
from repro_torch.distributed.steps import make_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.tensors import flatten_params
from repro_torch.roofline.analysis import CostCounter, Roofline, model_flops_for

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "dryrun_results_torch.json")
WORLD = 512  # ranks of the fake process group: the multi-pod mesh's


def init_fake_world(world: int = WORLD):
    """Join a fake process group of `world` ranks as rank 0 (no network,
    no data moves)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's tensors."""
    total = 0
    for _, t in flatten_params(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def trace_step(cfg, shape, mesh, step_kwargs=None):
    """Build the cell's step on `mesh`, place meta arguments and run it once
    under `CostCounter`.  Returns (the step, its per-chip `OpCosts`, the
    memory row, seconds)."""
    t0 = time.time()
    bundle = make_step(cfg, mesh, shape, **(step_kwargs or {}))
    counter = CostCounter()
    args = bundle.place(*bundle.args)  # meta shards: shapes only
    arg_bytes = sum(_local_bytes(a) for a in args)

    with counter:
        out = bundle.fn(*args)
    mem_row = {
        "argument_bytes": arg_bytes,
        "output_bytes": _local_bytes(out),
        "temp_bytes": None,
        "alias_bytes": None,
    }
    return bundle, counter.costs, mem_row, time.time() - t0


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, step_kwargs=None,
             pad_heads: bool = False):
    cfg = all_configs()[arch]
    if pad_heads and cfg.num_heads % 16:
        # §Perf: pad query heads to the TP axis (zero-init extras in a real
        # deployment) so attention shards by head instead of head_dim
        cfg = dataclasses.replace(cfg, num_heads=-(-cfg.num_heads // 16) * 16)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    bundle, costs, mem_row, t_trace = trace_step(cfg, shape, mesh, step_kwargs)
    roof = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=mesh.size(),
        hlo_flops_per_chip=costs.flops,
        hlo_bytes_per_chip=costs.dot_bytes,
        collective_bytes_per_chip=costs.collective_bytes,
        collectives=costs.collectives,
        model_flops=model_flops_for(cfg, shape),
        param_bytes=cfg.param_bytes(),
        memory_per_chip=mem_row,
    )
    row = roof.row()
    row.update({
        "ok": True,
        "trace_s": round(t_trace, 2),
        "lower_s": None,
        "compile_s": None,
        "xla_flops_per_chip_unrolled_once": None,
        "hlo_bytes_total_note": "matmul operands+outputs of rank 0's local ops",
        "step_desc": bundle.desc,
    })
    return row


def load_results(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_PATH))
    ap.add_argument("--tag", default=None, help="suffix for result keys (perf variants)")
    ap.add_argument("--moe-impl", default=None, choices=["scatter", "grouped", "gshard"])
    ap.add_argument("--moe-ep", action="store_true", help="expert-parallel constraint over the model axis")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--seq-shard-kv", action="store_true")
    args = ap.parse_args(argv)
    init_fake_world()

    step_kwargs = {}
    if args.moe_impl:
        step_kwargs["moe_impl"] = args.moe_impl
    if args.moe_ep:
        step_kwargs["moe_ep_axis"] = "model"
    if args.microbatches > 1:
        step_kwargs["microbatches"] = args.microbatches
    if args.seq_shard_kv:
        step_kwargs["seq_shard_kv"] = True

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    cells = [(a, s) for a, s in runnable_cells()
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    results = load_results(args.out)

    failures = 0
    for arch, shape_name in cells:
        for mesh_kind in meshes:
            key = f"{arch}|{shape_name}|{mesh_kind}"
            if args.tag:
                key += f"|{args.tag}"
            if key in results and results[key].get("ok") and not args.force:
                print(f"[skip] {key} (cached)")
                continue
            print(f"[run ] {key} ...", flush=True)
            t0 = time.time()
            try:
                row = run_cell(arch, shape_name, mesh_kind,
                               step_kwargs=step_kwargs, pad_heads=args.pad_heads)
                row["variant"] = args.tag or "baseline"
                row["step_kwargs"] = {**step_kwargs,
                                      "pad_heads": args.pad_heads}
                print(f"[ ok ] {key}: trace={row['trace_s']}s "
                      f"bottleneck={row['bottleneck']} "
                      f"compute={row['compute_s']*1e3:.1f}ms "
                      f"mem={row['memory_s']*1e3:.1f}ms "
                      f"coll={row['collective_s']*1e3:.1f}ms "
                      f"useful={row['useful_flops_ratio']:.2f}", flush=True)
            except Exception as e:  # noqa: BLE001 — a failed cell is a row, as in the reference
                failures += 1
                row = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:],
                       "elapsed_s": round(time.time() - t0, 1)}
                print(f"[FAIL] {key}: {row['error']}", flush=True)
            results[key] = row
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if not args.tag:
        for arch, shape_name, why in skipped_cells():
            key = f"{arch}|{shape_name}|skip"
            results[key] = {"ok": True, "skipped": True, "reason": why}
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok") and not r.get("skipped"))
    print(f"\ndone: {n_ok} cells ok, {failures} failures this run")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
