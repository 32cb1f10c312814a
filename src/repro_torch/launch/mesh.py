"""Production mesh builders (port of `repro/launch/mesh.py`) over
`torch.distributed`'s `DeviceMesh`.

Defined as FUNCTIONS so importing this module never touches process-group
state.  Single pod: (16, 16) = ("data", "model") — 256 ranks.  Multi-pod:
(2, 16, 16) = ("pod", "data", "model") — 512 ranks, the "pod" axis adds a
second data-parallel tier whose gradient reduction crosses the slowest
link.  Every mesh lies over the default process group, ranks in row-major
order; its device type is ``cuda`` unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh_compat(shape, axes, *, devices=None, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` named `axes` (the reference's
    `jax.make_mesh`) over the ranks `devices` (default: the first
    prod(shape) ranks of the default process group)."""
    n = math.prod(shape)
    ranks = torch.arange(n) if devices is None else torch.as_tensor(list(devices)[:n])
    if ranks.numel() != n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}; have {ranks.numel()}")
    return DeviceMesh(device_type, ranks.reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {have} — the dry-run entrypoint "
            "must first initialise the fake process group with 512 ranks "
            "(torch.distributed.init_process_group('fake', store=FakeStore(), "
            "rank=0, world_size=512))")
    return make_mesh_compat(shape, axes, device_type=device_type)


def make_local_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device_type: str = "cuda") -> DeviceMesh:
    """Mesh over however many ranks the default process group has
    (tests/examples)."""
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}; the default "
                           f"process group has {have}")
    return make_mesh_compat(shape, axes, device_type=device_type)
