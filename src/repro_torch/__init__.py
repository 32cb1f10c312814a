"""PyTorch + CUDA port of the Tangram reproduction (`repro` is the JAX reference).

The layout mirrors `repro` module for module.  Framework-neutral modules are
copies of their reference files with only the import lines redirected; the
model math, the tensor stores and the serving engine are rewritten over torch
tensors; the two Pallas kernels are CUDA C++ for Hopper under `csrc/`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; nothing falls back to the CPU when no card is present.
"""
