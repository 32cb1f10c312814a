"""Carry a parameter tree across from the reference package by leaf name.

The caller flattens the reference's tree to ``{leaf_path: numpy array}``
(numpy is the only currency both packages share); `params_from_numpy`
rebuilds the port's tree with the same stacked layout.  bfloat16 arrays come
as ml_dtypes arrays and cross as their raw 16-bit words, so this module never
needs ml_dtypes itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.models.common import resolve_device
from repro_torch.models.tensors import dtype_name, flatten_params, tree_structure, tree_unflatten


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over `a`'s bytes; bfloat16 goes through a uint16 view."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may be written to
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(named: dict[str, np.ndarray], cfg: ModelConfig,
                      device="cuda"):
    """Build the port's parameter tree for `cfg` on `device` from reference
    leaves keyed by `leaf_path`.  Every leaf must be present with the expected shape and
    dtype; extra names are an error too."""
    device = resolve_device(device)
    specs = build_model(cfg).param_specs()
    spec_leaves = flatten_params(specs)
    missing = [n for n, _ in spec_leaves if n not in named]
    extra = sorted(set(named) - {n for n, _ in spec_leaves})
    if missing or extra:
        raise KeyError(f"leaf mismatch: missing {missing}, unexpected {extra}")
    leaves = []
    for name, spec in spec_leaves:
        t = tensor_from_numpy(named[name])
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {dtype_name(t.dtype)}, "
                             f"expected {tuple(spec.shape)} {dtype_name(spec.dtype)}")
        leaves.append(t.to(device))
    return tree_unflatten(tree_structure(specs), leaves)
