"""How far a span's ``done`` lies from the profiler's end of its last kernel.

    PYTHONPATH=src python3 scripts/trace_done_offset.py [--requests 12]

On a CUDA card: a traced `Gateway` over two llama3.2-1b models at full
width (random weights) in a pool that holds one and a half of them, so
requests alternate re-assembled trees (an eager step and a capture) and
kept ones, prompt 256, 16 decode steps, served under `torch.profiler`.
The profiler's clock is tied to `perf_counter` by the benchmark's anchor
(`port_bench/pbench/probe.py` `Profiled`).  For each span that carries
``done`` (`prefill.forward`, `prefill.kv`, `decode.*`), the device
activities launched from the host inside the span (runtime calls and
device activities paired by correlation id) give the span's last device
end; the script prints, per span name, the count, the median and the
widest of ``done`` less that end, in microseconds, as one JSON line.  It
prints beside them how far each device activity starts after the runtime
call that launched it (``launch_lead_us``, min and median): a launch
cannot run before its call, so a lead far above a launch's few
microseconds is the profiler's device timeline sitting late against the
host's clock, which moves every offset by as much.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "port_bench"))
sys.path.insert(0, str(ROOT / "src"))
# the runtime calls whose correlation ids the device activities carry
RUNTIME = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
           "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    from pbench.probe import Profiled
    from repro_torch.configs import get_config
    from repro_torch.core.trace import Request
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.tensors import spec_records
    from repro_torch.obs import Tracer
    from repro_torch.serverless.gateway import Gateway
    from repro_torch.serving.engine import Engine

    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("llama3.2-1b")
    size = sum(r.nbytes for r in spec_records("a", cfg))
    tracer = Tracer(max_events=1 << 20)
    eng = Engine(size * 3 // 2 + (256 << 20), device=dev, tracer=tracer)
    for i, m in enumerate(("a", "b")):
        w = build_model(cfg).init(torch.Generator().manual_seed(i), device="cpu")
        eng.register(m, cfg, init_fn=lambda w=w: w)
    gw = Gateway(eng, keep_alive="zero", prompt_len=256, gen_tokens=16, num_pages=64)

    def trace(n, t0):
        return [Request(time=t0 + 100.0 * j, model_id="ab"[(j // 2) % 2], dataset="x",
                        prompt_tokens=256, output_tokens=16, batch_size=1) for j in range(n)]

    gw.run_trace(trace(4, 0.0))  # warm-up: every shape, a capture of each model
    with Profiled() as p:
        gw.run_trace(trace(args.requests, 1e4))
    host_of = {}  # correlation id -> host start of the runtime call (profiler ns)
    device = {}  # correlation id -> (first start, latest end) of its device activities
    for e in p.prof.profiler.kineto_results.events():
        c = e.correlation_id()
        if e.device_type() == DeviceType.CUDA:
            s0, e0 = device.get(c, (e.start_ns(), 0))
            device[c] = (min(s0, e.start_ns()), max(e0, e.start_ns() + e.duration_ns()))
        elif e.name() in RUNTIME:
            host_of[c] = e.start_ns()
    launches = sorted((h, device[c][1]) for c, h in host_of.items() if c in device)
    leads = [(device[c][0] - h) / 1e3 for c, h in host_of.items() if c in device]
    offsets, unmatched = {}, 0
    for ev in tracer.events():
        if not ev.args or "done" not in ev.args or ev.begin < p.t0:
            continue
        lo, hi = int(ev.begin * 1e9) + p.shift, int(ev.end * 1e9) + p.shift
        ends = [d for h, d in launches if lo <= h <= hi]
        if not ends:
            unmatched += 1
            continue
        last = (max(ends) - p.shift) / 1e9  # perf_counter seconds
        offsets.setdefault(ev.name, []).append((ev.args["done"] - last) * 1e6)
    out = {name: {"n": len(xs), "median_us": statistics.median(xs),
                  "widest_us": max(xs, key=abs), "min_us": min(xs)}
           for name, xs in sorted(offsets.items())}
    out["unmatched_spans"] = unmatched
    out["launch_lead_us"] = {"n": len(leads), "min": min(leads), "median": statistics.median(leads)}
    out["card"] = torch.cuda.get_device_name(dev)
    eng.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
