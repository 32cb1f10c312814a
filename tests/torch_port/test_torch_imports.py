"""The port stands alone: it imports without JAX, and no module of it (nor
chip_smoke.py) imports jax, ml_dtypes or the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_module_imports_no_jax_or_reference(rel):
    bad = imported_roots(ROOT / rel) & set(FORBIDDEN)
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.configs, repro_torch.core, repro_torch.obs\n"
        "import repro_torch.models.convert, repro_torch.kernels.ops\n"
        "import repro_torch.models.layers, repro_torch.models.encdec\n"
        "import repro_torch.serving.engine, repro_torch.serverless\n"
        "import repro_torch.serverless.gateway, repro_torch.serverless.fleet\n"
        "import repro_torch.core.cluster, repro_torch.launch.serve\n"
        "import repro_torch.train.optimizer, repro_torch.train.data\n"
        "import repro_torch.train.checkpoint, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.steps\n"
        "import repro_torch.distributed.compress, repro_torch.roofline.analysis\n"
        "import repro_torch.roofline.report, repro_torch.models.sharded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention"])
def test_every_kernel_has_its_cuda_source(name):
    from repro_torch.kernels import build

    assert name in build.SOURCES
    src = (build.CSRC / f"{name}.cu").read_text()
    assert f'extern "C" int {name}_launch' in src
    assert f"src/repro/kernels/{name}.py" in src  # names the TPU kernel it replaces


def test_kernel_library_path_tracks_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so it is rebuilt."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.lib_path("paged_attention")
    assert build.lib_path("paged_attention") == before  # stable
    (csrc / "paged_attention.cu").write_text(
        (csrc / "paged_attention.cu").read_text() + "\n// edit\n")
    assert build.lib_path("paged_attention") != before
    assert build.lib_path("flash_attention").parent == before.parent


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.common", ("causal_conv1d", "gelu_mlp")),
    ("repro_torch.models.layers", ("segsum", "ssd_chunked", "ssd_forward", "ssd_decode",
                                   "ssd_cache_spec", "linear_scan", "rglru_forward",
                                   "rglru_decode", "rglru_cache_spec")),
    ("repro_torch.models.encdec", ("layer_norm", "encode", "forward", "decode_step",
                                   "cache_specs")),
])
def test_state_family_modules_import_without_jax(module, names):
    """The state families' modules import with JAX and the reference
    blocked, and carry every function the reference's counterparts have."""
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"m = importlib.import_module({module!r})\n"
            f"missing = [n for n in {names!r} if not callable(getattr(m, n, None))]\n"
            "print(missing)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
