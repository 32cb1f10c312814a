"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""
import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_command():
    assert set(SPEC) == TOP_KEYS
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    for w in cmd:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in SPEC["paths"]), w
            assert not w.startswith("/") and ".." not in w.split("/")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check with 24 cells fits: (2 + 14 cells) runs of run_seconds + 60,
    # 2 x 90 s of compiling a cell, 1200 s spare, within 43200 s
    cells = 24
    assert (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and c["source"].startswith("https://")
        assert text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


def test_every_cell_reports_enough():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        others = [m for m in SPEC["end_to_end"] if m["name"] != "setup_s"
                  and cell in m.get("workloads", cells)]
        layers = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
        assert others and layers, cell
    # a kernel's roofline share and a share of a peak say so by name
    for m in SPEC["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("_roofline" in m["name"] for m in SPEC["per_layer"])
    for roof in [m for m in SPEC["per_layer"] if "_roofline" in m["name"]]:
        assert any("mfu" in m["name"] and m["moves"] == roof["moves"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"port_bench/configs/{conf['name']}.json"
    assert (ROOT / conf["file"]).is_file()
    traffic = json.loads((HERE / "traffic" / f"{cell}.json").read_text())
    models = {m["id"] for m in json.loads((ROOT / conf["file"]).read_text())["models"]}
    assert set(traffic["ranks"]) == models
    for m in SPEC["end_to_end"]:
        if m["name"] != "setup_s" and cell in m.get("workloads", [cell]):
            assert (HERE / "end_to_end" / f"{m['name']}.py").is_file(), m["name"]
    for m in SPEC["per_layer"]:
        if cell in m["workloads"]:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_reader_defines_read():
    from pbench import cell

    for kind, items in (("end_to_end", SPEC["end_to_end"]), ("metrics", SPEC["per_layer"])):
        for m in items:
            if m["name"] != "setup_s":
                assert callable(cell.reader(kind, m["name"]))


# program field -> the Hugging Face key that publishes it, where a model
# entry's `published_keys` does not say otherwise
PUBLISHED = {"d_model": "hidden_size", "num_layers": "num_hidden_layers",
             "num_heads": "num_attention_heads", "num_kv_heads": "num_key_value_heads",
             "vocab_size": "vocab_size", "rope_theta": "rope_theta", "norm_eps": "rms_norm_eps"}
PUBLISHED_MOE = {"moe_d_ff": "moe_intermediate_size", "num_experts": "num_experts",
                 "experts_per_token": "num_experts_per_tok"}
PUBLISHED_DENSE = {"d_ff": "intermediate_size"}


def assert_published(m: dict, run) -> None:
    """Each program field of `run` equals the published key that model entry
    `m` maps it to (`published_keys` over the defaults; every mapped field
    is compared).  Without a mapping, ``head_dim`` is the published one or
    hidden_size / num_attention_heads."""
    keys = {**PUBLISHED, **(PUBLISHED_MOE if run.is_moe else PUBLISHED_DENSE),
            **m.get("published_keys", {})}
    hf = m["config"]
    for field, key in keys.items():
        assert isinstance(key, str), (m["id"], field, key)
        value = run.resolved_head_dim if field == "head_dim" else getattr(run, field)
        assert hf[key] == value, (m["id"], field, key)
    if "head_dim" not in keys:
        assert (hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"])
                == run.resolved_head_dim), m["id"]


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_configuration_file(conf):
    """The file runs the program's own configuration of each model, cut only
    in the keys it lists; its Hugging Face keys say the same; the pool is
    the stated arithmetic."""
    from repro_torch.configs import get_config

    from pbench import cell

    entry = next(c for c in SPEC["configs"] if c["name"] == conf)
    data = json.loads((ROOT / entry["file"]).read_text())
    reduced = set()
    cfgs = cell.model_configs(data)
    sizes = cell.model_bytes(cfgs)
    for m in data["models"]:
        assert m["source"].startswith("https://huggingface.co/")
        assert isinstance(m["assumed"], list) and isinstance(m["departures"], list)
        reduced |= set(m["reduced"])
        run = cfgs[m["id"]]
        program = get_config(m["id"])
        cut = {"num_layers"} if "num_hidden_layers" in m["reduced"] else set()
        # where the program's registered configuration departs from the
        # published model, the file says so and runs the published value
        differs = {k: v for k, v in m.get("program_differs", {}).items() if k != "why"}
        for f in dataclasses.fields(program):
            if f.name in differs:
                assert getattr(program, f.name) == differs[f.name]["program"], (m["id"], f.name)
                assert getattr(run, f.name) == differs[f.name]["run"], (m["id"], f.name)
            elif f.name not in cut:
                assert getattr(run, f.name) == getattr(program, f.name), (m["id"], f.name)
        assert_published(m, run)
        hf = m["config"]
        for key, cut_to in m["reduced"].items():
            assert hf[key] == cut_to["run"] and cut_to["published"] != cut_to["run"]
        assert m["bytes"] == sizes[m["id"]]
    assert reduced == set(entry["reduced"])
    assert data["pool"]["bytes"] == cell.pool_bytes(data, cfgs)


def test_published_keys_are_compared_through_the_map():
    """A model that publishes its sizes under other names (DeepSeek's
    `n_routed_experts`, a dense first layer's `intermediate_size` beside the
    experts' `moe_intermediate_size`) is compared through its map, and a
    wrong mapped value fails."""
    from pbench import cell

    data = json.loads((HERE / "configs" / "moe-duo.json").read_text())
    m = next(x for x in data["models"] if x["id"] == "qwen3-moe-30b-a3b")
    run = cell.model_configs(data)[m["id"]]
    hf = dict(m["config"])
    hf["n_routed_experts"] = hf.pop("num_experts")
    hf["dense_width"] = run.d_ff
    entry = dict(m, config=hf, published_keys={"num_experts": "n_routed_experts",
                                               "d_ff": "dense_width"})
    assert_published(entry, run)
    with pytest.raises(KeyError):
        assert_published(dict(entry, published_keys={}), run)  # today's names alone
    with pytest.raises(AssertionError):
        assert_published(dict(entry, config=dict(hf, n_routed_experts=64)), run)
    with pytest.raises(AssertionError):
        assert_published(dict(entry, config=dict(hf, dense_width=10944)), run)
    for note in ([], ["d_ff: no dense layer, the program's default"]):
        with pytest.raises(AssertionError):  # a field is never left uncompared
            assert_published(dict(entry, assumed=note, departures=note,
                                  published_keys={"num_experts": "n_routed_experts",
                                                  "d_ff": None}), run)


def test_kv_arithmetic_follows_the_engine():
    """The pool's KV term assumes the Engine's block and ElasticKV's region
    sizes."""
    import inspect

    from repro_torch.serving.engine import Engine

    from pbench import cell

    assert inspect.signature(Engine.__init__).parameters["block_tokens"].default == cell.BLOCK_TOKENS
    assert "blocks_per_region=16" in inspect.getsource(Engine.start_instance)
    assert cell.REGION_BLOCKS == 16


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_reference_package():
    for path in HERE.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    for path in (HERE / "reference").rglob("*.py"):
        assert not (_imports(path) & {"repro_torch", "pbench"}), path


def test_no_module_the_run_loads_is_jax():
    """Every module the harness, its readers and the reference modules the
    configurations name load, the program's entry points with them,
    compared by whole top-level name (the program's
    `repro_torch` begins with the reference's `repro`)."""
    code = f"""
import sys
sys.path[:0] = [{str(HERE)!r}, {str(ROOT / 'src')!r}]
import run
from pbench import cell, check, probe, serve, counts, traffic, stats, weights
from reference import lm
import reference
serve.engine_classes()
import json
spec = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for c in spec["configs"]:
    for m in json.load(open({str(ROOT)!r} + "/" + c["file"]))["models"]:
        reference.load(reference.module_of(m))
for kind, items in (("end_to_end", spec["end_to_end"]), ("metrics", spec["per_layer"])):
    for m in items:
        if m["name"] != "setup_s":
            cell.reader(kind, m["name"])
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "repro_torch" in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


def test_run_refuses_without_a_card(tmp_path):
    """No card, or no program beside the benchmark: exit 2, no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure it")
    args = ["--workload", SPEC["workloads"][0]["name"], "--seed", str(2**31 + 7),
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "port_bench/run.py", *args], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == "", out.stderr
    bare = tmp_path / "checkout"
    (bare / "port_bench").mkdir(parents=True)
    (bare / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    for f in HERE.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            dst = bare / "port_bench" / f.relative_to(HERE)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(f.read_bytes())
    out = subprocess.run([sys.executable, "port_bench/run.py", *args], capture_output=True,
                         text=True, timeout=300, cwd=bare)
    assert out.returncode != 0 and out.stdout == "", out.stderr
