"""Shared helpers for the port's parity tests: carry arrays between the JAX
reference and the PyTorch port as numpy, in both directions."""
import numpy as np
import torch

# tests/test_kernels.py's tolerances: fp32 sums in another order, bf16 rounds
# at other places in the two frameworks
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def ref_named_numpy(params) -> dict:
    """Flatten a reference parameter tree to {leaf_path: numpy array}."""
    import jax

    from repro.models.tensors import leaf_path

    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {leaf_path(path): np.asarray(leaf) for path, leaf in leaves}


def to_torch(a, device="cpu") -> torch.Tensor:
    """A reference array (jax or numpy, bf16 included) as a torch tensor."""
    from repro_torch.models.convert import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a)).to(device)


def to_f32(x) -> np.ndarray:
    """Either framework's array as float32 numpy, for comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def max_err(a, b) -> float:
    return float(np.max(np.abs(to_f32(a) - to_f32(b))))
