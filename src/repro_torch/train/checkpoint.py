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
  * elastic: `restore(..., devices=...)` places every leaf on the device
    the given tree names, so a restart may change placement;
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

from repro_torch.models.tensors import (dtype_name, flatten_params, tree_structure,
                                        tree_unflatten)

# dtypes npz stores as they are; any other (bf16) is stored as f32
NPZ_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
            "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _flatten(tree) -> dict[str, Any]:
    return {(name or f"leaf{i}"): leaf
            for i, (name, leaf) in enumerate(flatten_params(tree))}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = _to_host(t)
    if dtype_name(t.dtype) not in NPZ_SAFE:
        t = t.to(torch.float32)
    return t.numpy()


def save(directory: str, step: int, tree: Any, *, blocking: bool = True) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    named = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in named.items()}
    true_dtypes = {k: dtype_name(v.dtype) for k, v in named.items()}

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


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            devices: Any = None) -> Any:
    """Rebuild the tree of `like` from disk, each leaf in its `like` leaf's
    dtype, on that leaf's device or, given `devices` (a tree of the same
    structure whose leaves are `torch.device`s), on the device it names:
    elastic restart onto a new placement.  A checkpoint whose leaf names
    differ from `like`'s raises `AssertionError`."""
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
    flat_dev = _flatten(devices) if devices is not None else None
    out = []
    for name, leaf in flat_like.items():
        dev = flat_dev[name] if flat_dev is not None else leaf.device
        out.append(torch.from_numpy(named[name]).to(device=dev, dtype=leaf.dtype))
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

    def restore_latest(self, like, *, devices=None):
        self.wait()
        return restore(self.directory, like, devices=devices)
