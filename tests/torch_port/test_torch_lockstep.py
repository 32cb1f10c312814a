"""Every framework-neutral module the port copies stays equal to its
reference file, import statements aside (they are redirected to
`repro_torch`)."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIED = [
    "stats.py",
    "obs/__init__.py", "obs/ring.py", "obs/tracer.py", "obs/metrics.py",
    "obs/accounting.py", "obs/export.py",
    "core/regions.py", "core/allocator.py", "core/costmodel.py",
    "core/reuse_store.py", "core/elastic_kv.py", "core/faults.py",
    "core/trace.py", "core/scheduler.py", "core/hostcache.py",
    "core/engine_api.py", "core/cluster.py", "core/__init__.py", "core/mcmdkp.py",
    "serverless/workload.py", "serverless/lifecycle.py", "serverless/__init__.py",
    "configs/__init__.py", "models/__init__.py", "roofline/report.py",
] + sorted(f"configs/{p.name}" for p in (REF / "configs").glob("*.py")
           if p.name not in ("__init__.py", "base.py"))


def without_imports(path: Path) -> list[str]:
    """The file's lines with every import statement (at any depth, all of
    its continuation lines included) removed."""
    text = path.read_text()
    drop = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [line for i, line in enumerate(text.splitlines(), 1) if i not in drop]


# the one deliberate edit of a copy besides its imports: a docstring that
# dated a fix by its change number
EDITS = {"obs/accounting.py": (re.compile(r"bug P[R] [0-9]+ fixed"), "bug once fixed")}


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_reference(rel):
    ref = without_imports(REF / rel)
    if rel in EDITS:
        pattern, repl = EDITS[rel]
        ref = [pattern.sub(repl, line) for line in ref]
    assert without_imports(PORT / rel) == ref


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_imports_only_port(rel):
    for node in ast.walk(ast.parse((PORT / rel).read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] != "repro", (rel, node.module)


def test_config_base_differs_only_in_dtype_property():
    """configs/base.py is the one edited copy: `torch_dtype` replaces
    `jnp_dtype`; kv_bytes_per_token keeps dtype_bytes=2 for every config."""
    ref = without_imports(REF / "configs/base.py")
    port = without_imports(PORT / "configs/base.py")
    swap = {"    def jnp_dtype(self):": "    def torch_dtype(self) -> torch.dtype:",
            "        return jnp.dtype(self.dtype)": "        return getattr(torch, self.dtype)"}
    assert [swap.get(line, line) for line in ref] == port


def test_copy_list_covers_every_ported_verbatim_module():
    """A port module that equals its reference (imports aside) belongs in
    the list above, so a later edit is caught."""
    for path in sorted(PORT.rglob("*.py")):
        rel = str(path.relative_to(PORT))
        ref = REF / rel
        if ref.exists() and rel not in COPIED and rel != "configs/base.py":
            assert without_imports(path) != without_imports(ref), rel
