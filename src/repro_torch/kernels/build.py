"""Build and load the CUDA kernels under `repro_torch/csrc/`.

Each `*.cu` source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with `ctypes`.  Libraries go
to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built.  Nothing is built when a
module is imported: `build_all` starts every needed compile at once (one
``nvcc`` per source, in parallel), and `library` builds one on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
SOURCES = ("paged_attention", "flash_attention")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    """Where the library of source `name` lives for the current sources."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # the source and the shared headers
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=SOURCES, timeout_s: float = 600.0) -> dict[str, str]:
    """Compile every source in `names` that has no current library, all at
    once.  Returns each compiled source's nvcc output (register and shared
    memory use from ``-Xptxas -v``); raises `KernelBuildError` on failure."""
    started = {n: _start(n) for n in names}
    logs: dict[str, str] = {}
    errors = []
    try:
        for name, job in started.items():
            if job is None:
                continue
            proc, tmp, out = job
            text, _ = proc.communicate(timeout=timeout_s)
            logs[name] = text
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
    finally:
        for job in started.values():
            if job is not None:
                if job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
                job[1].unlink(missing_ok=True)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(lib_path(name)))
