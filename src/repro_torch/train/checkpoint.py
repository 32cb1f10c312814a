"""Tensor-level checkpointing with async save and elastic restore (port of
`repro/train/checkpoint.py`).

Each tree leaf is saved as one entry of an .npz plus a JSON manifest
(paths, shapes, dtypes, step), the reference's on-disk format: entries are
named by `models.tensors.flatten_params` leaf paths (the reference's
`_path_str` names), and bf16 leaves are stored as f32 with their true dtype
in the manifest.  So a checkpoint written by either package restores into
the other.

Fault-tolerance properties:
  * atomic: writes to <dir>/tmp-<step> then renames to step-<step:08d>;
  * async: `CheckpointManager.save` copies every leaf to the host (one
    device-to-host copy per leaf, on the caller's stream) before a
    background thread serialises and writes; `wait()` joins;
  * sharded: a DTensor leaf is written whole (`full_tensor()`, a
    collective every rank of its mesh calls), and only rank 0 of the
    default process group writes;
  * elastic: `restore(..., shardings=...)` places every leaf on the device
    or the (mesh, placements) the given tree names, so a restart may change
    the mesh;
  * bounded: keeps the newest `keep` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.tensors import (dtype_name, flatten_params, tree_structure,
                                        tree_unflatten)

# dtypes npz stores as they are; any other (bf16) is stored as f32
NPZ_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
            "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _flatten(tree) -> dict[str, Any]:
    return {(name or f"leaf{i}"): leaf
            for i, (name, leaf) in enumerate(flatten_params(tree))}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` whole on the host (a DTensor gathered: every rank calls this)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to("cpu")


def _writer() -> bool:
    """Whether this process writes: rank 0 of the default process group,
    or the only process there is."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = _to_host(t)
    if dtype_name(t.dtype) not in NPZ_SAFE:
        t = t.to(torch.float32)
    return t.numpy()


def save(directory: str, step: int, tree: Any, *, blocking: bool = True) -> str:
    """Write `tree` as checkpoint `step`; returns its final path.  Under a
    process group every rank calls it (DTensor leaves gather whole) and
    rank 0 writes: another rank that restores waits for it first (a
    barrier)."""
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    named = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in named.items()}
    true_dtypes = {k: dtype_name(v.dtype) for k, v in named.items()}
    if not _writer():
        return final
    os.makedirs(tmp, exist_ok=True)

    def _write():
        np.savez(os.path.join(tmp, "tensors.npz"), **arrays)
        manifest = {
            "step": step,
            "tensors": {k: {"shape": list(a.shape), "dtype": true_dtypes[k]}
                        for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        _write()
        return final
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(directory)
             if d.startswith("step-")]
    return max(steps) if steps else None


def _is_sharding(node) -> bool:
    return (isinstance(node, tuple) and len(node) == 2
            and isinstance(node[0], DeviceMesh))


def _sharding_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """`flatten_params` over a shardings tree whose (mesh, placements)
    pairs are leaves."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _sharding_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and not _is_sharding(tree):
        return [kv for i, sub in enumerate(tree) for kv in _sharding_leaves(sub, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _placed(a: np.ndarray, dtype: torch.dtype, where) -> torch.Tensor:
    """The whole leaf `a` as `dtype` on `where`: a device, or a (mesh,
    placements) pair (each rank keeps its own shard: every rank read the
    same file)."""
    if not _is_sharding(where):
        return torch.from_numpy(a).to(device=where, dtype=dtype)
    mesh, placements = where
    t = torch.from_numpy(a).to(device=mesh.device_type, dtype=dtype)
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Rebuild the tree of `like` from disk, each leaf in its `like` leaf's
    dtype and placement (a DTensor's mesh and placements, else its device)
    or, given `shardings` (a tree of the same structure whose leaves are
    `torch.device`s or (DeviceMesh, placements) pairs), where it names:
    elastic restart onto a new mesh.  A checkpoint whose leaf names differ
    from `like`'s raises `AssertionError`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step-{step:08d}")
    with np.load(os.path.join(path, "tensors.npz")) as z:
        named = {k: z[k] for k in z.files}
    flat_like = _flatten(like)
    assert set(named) == set(flat_like), (
        f"checkpoint/model mismatch: {set(named) ^ set(flat_like)}")
    flat_where = ({(n or f"leaf{i}"): w for i, (n, w) in enumerate(_sharding_leaves(shardings))}
                  if shardings is not None else None)
    out = []
    for name, leaf in flat_like.items():
        if flat_where is not None:
            where = flat_where[name]
        elif isinstance(leaf, DTensor):
            where = (leaf.device_mesh, tuple(leaf.placements))
        else:
            where = leaf.device
        out.append(_placed(named[name], leaf.dtype, where))
    return tree_unflatten(tree_structure(like), out)


class CheckpointManager:
    """Async, bounded-retention checkpoint manager."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any):
        self.wait()
        # capture host copies now: the caller may update the tree in place
        host = tree_unflatten(tree_structure(tree),
                              [_to_host(t) for _, t in flatten_params(tree)])
        if not _writer():
            return

        def _job():
            try:
                save(self.directory, step, host, blocking=True)
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_job, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(d.split("-")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step-"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like, *, shardings=None):
        self.wait()
        return restore(self.directory, like, shardings=shardings)
