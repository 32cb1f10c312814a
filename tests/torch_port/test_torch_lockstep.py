"""Every framework-neutral module the port copies stays equal to its
reference file, import statements aside (they are redirected to
`repro_torch`)."""
import ast
import dataclasses
import difflib
import re
from pathlib import Path

import pytest

from repro_torch.configs import all_configs as all_port_configs

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
    `jnp_dtype`; kv_bytes_per_token keeps dtype_bytes=2 for every config.
    Beside that it only adds lines, never changes or drops one of the
    reference's: the port-only architectures' fields (latent attention,
    YaRN, shared experts, leading dense layers, `norm_topk_prob`), each with
    a default that leaves every registered model as it is, and the code
    that reads them."""
    ref = without_imports(REF / "configs/base.py")
    port = without_imports(PORT / "configs/base.py")
    swap = {"    def jnp_dtype(self):": "    def torch_dtype(self) -> torch.dtype:",
            "        return jnp.dtype(self.dtype)": "        return getattr(torch, self.dtype)"}
    ref = [swap.get(line, line) for line in ref]
    added = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes():
        assert op in ("equal", "insert"), (op, ref[i1:i2], port[j1:j2])
        if op == "insert":
            added += port[j1:j2]
    fields = [line for line in added if re.match(r"^    [a-z_]+: [^=()]+(=|$)", line)]
    assert fields and all("=" in line for line in fields), fields


def _reference_configs() -> dict:
    pytest.importorskip("jax")  # the reference's configs import it
    from repro.configs import all_configs
    return all_configs()


def _same_config(port, ref):
    """`port` holds `ref`'s value in every field of the reference, the
    port-only fields' defaults, and the same derived sizes."""
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name) if f.name in ref_fields else f.default
        assert getattr(port, f.name) == want, (port.name, f.name)
    assert port.segments == ref.segments
    assert port.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert port.param_count() == ref.param_count()
    assert port.param_bytes() == ref.param_bytes()


def test_port_registers_the_reference_architectures():
    assert sorted(all_port_configs()) == sorted(_reference_configs())


@pytest.mark.parametrize("name", sorted(all_port_configs()))
def test_config_base_gives_the_reference_values(name):
    """The fields base.py adds leave every architecture the reference
    registers as it is: its fields, segments, KV bytes a token, parameter
    count, and the same again of its smoke() variant."""
    from repro_torch.configs import get_config
    ref, port = _reference_configs()[name], get_config(name)
    _same_config(port, ref)
    _same_config(port.smoke(), ref.smoke())


def test_copy_list_covers_every_ported_verbatim_module():
    """A port module that equals its reference (imports aside) belongs in
    the list above, so a later edit is caught."""
    for path in sorted(PORT.rglob("*.py")):
        rel = str(path.relative_to(PORT))
        ref = REF / rel
        if ref.exists() and rel not in COPIED and rel != "configs/base.py":
            assert without_imports(path) != without_imports(ref), rel


@pytest.mark.parametrize("name", ["Prefetcher", "PrefetchJob"])
def test_prefetcher_class_matches_reference(name):
    """serving/engine.py differs from the reference (the engine's tensors),
    but its store->host promotion pipeline is framework-neutral: the two
    classes' syntax trees are equal."""
    def classes(path: Path) -> dict:
        return {n.name: ast.dump(n) for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.ClassDef)}

    rel = "serving/engine.py"
    assert classes(PORT / rel)[name] == classes(REF / rel)[name]
