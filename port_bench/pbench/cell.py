"""One run of one cell: set-up, the measured window, the readings, the
check, and the result line's object.

Everything a cell needs is found by name: its entry in BENCHMARK.json
names a configuration (``configs/<config>.json``) and, by the cell's own
name, a traffic file (``traffic/<cell>.json``); each metric the cell
reports is a reader ``end_to_end/<metric>.py`` or ``metrics/<metric>.py``
with one function, ``read(ctx)``, that returns a number or None (nothing
to read in this run: the metric is left out of the line).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from pbench import check, probe, traffic as tr
from pbench.serve import Window, engine_classes, graph_counts, prompt_tokens, serve
from pbench.weights import draw

HERE = Path(__file__).resolve().parents[1]  # port_bench/
WARMUP_SPACING_S = 1000.0  # trace seconds between warm-up requests: none queues
BLOCK_TOKENS = 16  # Engine's default KV block
REGION_BLOCKS = 16  # blocks ElasticKV takes from the pool at a time (Engine.start_instance)
PROBE_PROMPTS = 3  # the probe's prompts' stream of the run's seed (the window's is 1)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no entry named {name!r}")


def model_configs(conf: dict, *, shrink=None) -> dict:
    """model id -> the program's `ModelConfig` of the configuration file's
    ``port`` section (`shrink(cfg)`: a smaller one, for tests)."""
    from repro_torch.configs.base import ModelConfig

    out = {}
    for m in conf["models"]:
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in m["port"].items()})
        out[m["id"]] = shrink(cfg) if shrink is not None else cfg
    return out


def model_bytes(cfgs: dict) -> dict:
    from repro_torch.models.tensors import spec_records

    return {m: sum(r.nbytes for r in spec_records(m, cfg)) for m, cfg in cfgs.items()}


def kv_request_bytes(cfg, tokens: int) -> int:
    """Pool bytes one B 1 request of `tokens` tokens holds: ElasticKV takes
    whole regions of REGION_BLOCKS blocks of BLOCK_TOKENS tokens."""
    blocks = -(-tokens // BLOCK_TOKENS)
    regions = -(-blocks // REGION_BLOCKS)
    return regions * REGION_BLOCKS * BLOCK_TOKENS * cfg.kv_bytes_per_token()


def pool_bytes(conf: dict, cfgs: dict) -> int:
    """The pool the configuration states: the weights of `pool.weights` and
    one request's KV of each model in `pool.kv_of`, at `pool.kv_tokens`."""
    p = conf["pool"]
    sizes = model_bytes(cfgs)
    return (sum(sizes[m] for m in p["weights"])
            + sum(kv_request_bytes(cfgs[m], p["kv_tokens"]) for m in p["kv_of"]))


def reader(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


@dataclass
class Context:
    """What the readers read."""

    cfgs: dict  # model id -> the configuration file's port section
    traffic: dict
    window: Window
    model_bytes: dict
    steps: list = field(default_factory=list)  # probe.StepReading per model
    slice: object = None  # probe.DeviceTrace of the profiled slice

    @property
    def served(self) -> list:
        return [s for s in self.window.served if not s.failed]


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", shrink=None,
        control: bool = False, readings: bool = False, log=print,
        traffic: dict | None = None, weights_cache: dict | None = None) -> dict:
    """One run; returns the result line's object (with `readings`, every
    reading of the check under ``readings``; with `control`, the float8
    control's too).  `shrink(cfg)` cuts
    every model (tests only: the pool follows the configuration's rule).
    `traffic` overrides entries of the cell's traffic file (the rate
    sweep's rates, a test's limits); `weights_cache` keeps the drawn weights
    across runs of one process (the sweep's, at one seed)."""
    bench = spec(root)
    cell = find(bench["workloads"], workload)
    conf = load_json(root / find(bench["configs"], cell["config"])["file"])
    refs = check.references(conf)  # before anything is built or drawn
    tf = {**load_json(HERE / "traffic" / f"{workload}.json"), **(traffic or {})}
    dev = torch.device(device)
    cfgs = model_configs(conf, shrink=shrink)
    sizes = model_bytes(cfgs)
    pool = pool_bytes(conf, cfgs)
    if shrink is None and pool != conf["pool"]["bytes"]:
        raise SystemExit(f"pool arithmetic gives {pool} B, the file states {conf['pool']['bytes']}")
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all()
    log(f"port_bench: {workload} seed {seed}: pool {pool} B, models {sizes}")

    log(f"port_bench: kernels ready at {time.perf_counter() - t_start:.1f} s")
    weights, trees = {}, {}
    cache = weights_cache if weights_cache is not None else {}
    for i, (mid, cfg) in enumerate(cfgs.items()):
        key = (mid, seed, shrink is None)
        if key not in cache:
            cache[key] = draw(cfg, tr.mix(seed, 0, i), dev, conf.get("draw"))
        trees[mid], weights[mid] = cache[key]
    log(f"port_bench: weights drawn and page-locked at {time.perf_counter() - t_start:.1f} s")
    tracer = None
    if trace:
        from repro_torch.obs import Tracer

        tracer = Tracer(max_events=1 << 20)
    RecordingEngine, BenchGateway = engine_classes()
    eng = RecordingEngine(pool, device=dev, tracer=tracer, bench_tracer=tracer)
    for mid, cfg in cfgs.items():
        eng.register(mid, cfg, init_fn=lambda t=trees[mid]: t)
    gw = BenchGateway(eng, seed=seed, keep_alive=tf["keep_alive"],
                      prompt_len=tf["prompt_tokens"], gen_tokens=tf["decode_steps"])
    warm = tr.warmup(tf, WARMUP_SPACING_S)
    arrivals = tr.arrivals(tf, start=warm[-1].time + WARMUP_SPACING_S)  # endless
    index = serve(gw, iter(warm), 0, tf["slice_requests"])
    if dev.type == "cuda":
        torch.cuda.synchronize()

    log(f"port_bench: warm-up served at {time.perf_counter() - t_start:.1f} s")
    win = Window(graphs_before=graph_counts(eng))
    win.start = time.perf_counter()
    setup_s = win.start - t_start
    index = serve(gw, arrivals, index, tf["slice_requests"], until=win.start + seconds,
                  window=win)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    win.end = time.perf_counter()
    win.graphs_after = graph_counts(eng)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for s in win.served:
        log(request_line(s))

    ctx = Context({m: _port_dict(c) for m, c in cfgs.items()}, tf, win, sizes)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    log(f"port_bench: window closed at {time.perf_counter() - t_start:.1f} s")
    if trace and dev.type == "cuda":
        with probe.Profiled() as p:
            serve(gw, arrivals, index, tf["slice_requests"], count=tf["profile_requests"])
        ctx.slice = probe.read_slice(p, probe.tracer_spans(tracer))
        gw._expire(math.inf)  # keep-alives lapse: the probe loads each model in turn
        for i, mid in enumerate(cfgs):
            prompt = prompt_tokens(seed, PROBE_PROMPTS, i, tf["prompt_tokens"],
                                   cfgs[mid].vocab_size)
            ctx.steps.append(probe.step_probe(eng, mid, prompt, tf["probe_steps"]))
        log(f"port_bench: slice profiled and steps probed at {time.perf_counter() - t_start:.1f} s")
        device_info["busy_s"] = ctx.slice.busy_s
        device_info["window_s"] = ctx.slice.window_s
        ops = sorted(ctx.slice.ops.items(), key=lambda kv: -kv[1])[: probe.TOP]
        breakdown = {"device_ops": [[n, s] for n, s in ops],
                     "idle_gaps": [[n, s] for n, s in ctx.slice.gaps]}
    elif trace:
        device_info["busy_s"] = 0.0
        device_info["window_s"] = 0.0

    # the program's state goes before the reference runs
    eng.close()
    del gw, eng, trees
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picked = check.sample(ctx.served, tf["check_requests"], seed)
    found = check.gaps(weights, ctx.cfgs, picked, dev, refs, control=control)
    log(f"port_bench: reference checked at {time.perf_counter() - t_start:.1f} s")
    limits = tf["limits"]
    checks = {name: {"value": found[name], "limit": limit}
              for name, limit in limits.items() if name != "min_tokens_compared"}
    checks["tokens_compared"] = {"value": found["tokens"],
                                 "limit": limits["min_tokens_compared"]}
    checks["failed_requests"] = {"value": win.failed, "limit": 0}
    correct = (all(c["value"] <= c["limit"] for n, c in checks.items() if n != "tokens_compared")
               and found["tokens"] >= limits["min_tokens_compared"]
               and len(win.served) > 0)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in bench[kind]:
        if m["name"] == "setup_s" or workload not in m.get("workloads", [workload]):
            continue
        value = reader("metrics" if trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(win.served), "failed": win.failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if readings or control:
        out["readings"] = found
    out["checks"] = checks
    return out


def request_line(s) -> str:
    """One window request's phases, for the run's log."""
    if s.failed:
        return f"request t={s.arrival.time:.3f} {s.arrival.model_id} FAILED"
    r, st = s.record, s.load[1]
    return (f"request t={s.arrival.time:.3f} {s.arrival.model_id} {check.load_kind(st)} "
            f"cold={int(r.cold)} queue={r.queue_s:.4f} init={r.init_s:.4f} load={r.load_s:.4f} "
            f"profile={r.profile_s:.4f} prefill={r.prefill_s:.4f} decode={r.decode_s:.4f} "
            f"h2d={st.bytes_h2d} hit={st.bytes_device_hit}")


def _port_dict(cfg) -> dict:
    import dataclasses

    d = dataclasses.asdict(cfg)
    d["head_dim"] = cfg.resolved_head_dim
    return d
