"""The traced run's readings of the device (CUDA only).

  * `profile_slice`: `torch.profiler` over a few more requests of the
    cell's trace, served right after the window closes: the device's busy
    time (the union of every kernel, copy and fill it ran), the slice's
    wall, the operations that took most time, and the longest idle gaps,
    each named by the innermost span of the port's `Tracer` (and the
    benchmark's own prefill and decode-step spans) open on the host at the
    gap's middle;
  * `step_probe`: for each model of the configuration, on the same engine,
    a B 1 prefill at the cell's prompt timed between CUDA events, decode
    steps from a second one (first a round that makes the key's eager step
    and capture, then a round of replays timed between CUDA events), and
    last one profiled session of a prefill (K2's device time) and a round
    of replays (K1's device time, and the routed experts' kernels').

The profiler's clock and the tracer's are tied by one annotated range
opened at a known `time.perf_counter`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

K1_KERNEL = "paged_attention_kernel"
K2_KERNEL = "flash_bf16_kernel"
MOE_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")
TOP = 10


@dataclass
class DeviceTrace:
    window_s: float = 0.0
    busy_s: float = 0.0
    ops: dict = field(default_factory=dict)  # name -> device seconds
    gaps: list = field(default_factory=list)  # (host span, seconds), longest first


def _device_events(prof):
    """(name, start_ns, end_ns) of every device activity, and the clock
    offset (profiler ns minus perf_counter ns) from the anchor range."""
    from torch.autograd import DeviceType

    evs, offset = [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            evs.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() == "port_bench.anchor" and offset is None:
            offset = e.start_ns()
    return evs, offset


class Profiled:
    """A `torch.profiler` window whose device activity is read on exit."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        with record_function("port_bench.anchor"):
            self.anchor = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.events, anchor_ns = _device_events(self.prof)
        # profiler ns = perf_counter ns + shift
        self.shift = (anchor_ns - self.anchor) if anchor_ns is not None else None
        return False

    def kernel_seconds(self, needle: str, since_ns: int | None = None) -> float:
        """Device seconds of the kernels named like `needle`; with
        `since_ns` (a `time.perf_counter_ns`) only of those that started
        after it, none where the profiler's clock is not tied to it."""
        if since_ns is not None:
            if self.shift is None:
                return 0.0
            since_ns += self.shift
        return sum(e - s for n, s, e in self.events
                   if needle in n and (since_ns is None or s >= since_ns)) / 1e9


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_slice(p: Profiled, spans) -> DeviceTrace:
    """The slice's busy time, top operations and longest idle gaps; `spans`
    are the tracer's (name, begin, end) in perf_counter seconds."""
    dt = DeviceTrace(window_s=p.t1 - p.t0)
    if not p.events or p.shift is None:
        return dt
    lo = int(p.t0 * 1e9) + p.shift
    hi = int(p.t1 * 1e9) + p.shift
    merged = _union([(max(s, lo), min(e, hi)) for _, s, e in p.events if e > lo and s < hi])
    dt.busy_s = sum(e - s for s, e in merged) / 1e9
    for n, s, e in p.events:
        dt.ops[n] = dt.ops.get(n, 0.0) + (e - s) / 1e9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps = [(lo, merged[0][0])] + gaps + [(merged[-1][1], hi)]
    # only spans open during the slice can hold a gap's middle: the window's
    # tens of thousands of spans would cost seconds for every thousand gaps
    spans = [sp for sp in spans if sp[2] >= p.t0 - 1e-6 and sp[1] <= p.t1 + 1e-6]
    named = {}
    for s, e in gaps:
        if e <= s:
            continue
        mid = ((s + e) / 2 - p.shift) / 1e9  # perf_counter seconds
        inner = [(b2 - b1, name) for name, b1, b2 in spans if b1 <= mid <= b2]
        name = min(inner)[1] if inner else "outside any span"
        named.setdefault(name, []).append((e - s) / 1e9)
    longest = sorted(((name, g) for name, gs in named.items() for g in gs),
                     key=lambda x: -x[1])
    dt.gaps = longest[:TOP]
    return dt


def tracer_spans(tracer) -> list[tuple[str, float, float]]:
    """The tracer's spans on the host clock (the engine's and the
    benchmark's tracks; the Gateway's own spans run on the trace clock)."""
    return [(ev.name, ev.begin, ev.end) for ev in tracer.events()
            if ev.end is not None and ev.track != "main"]


@dataclass
class StepReading:
    model_id: str
    prompt: int
    prefill_s: float  # one prefill between CUDA events
    k2_s: float  # K2's device time in one profiled prefill
    decode_step_s: float  # a replayed step between CUDA events
    k1_step_s: float  # K1's device time a profiled step
    mean_length: float  # keys a timed step attends to, on average
    steps: int
    experts_step_s: float = 0.0  # the routed experts' kernels' device time a profiled step


def _timed(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def step_probe(engine, model_id: str, prompt: torch.Tensor, steps: int) -> StepReading:
    """Prefill and decode-step readings of `model_id` at `prompt`'s length."""
    from repro_torch.serverless.gateway import greedy

    dev = engine.device
    batch = {"tokens": prompt.to(dev)}
    S = prompt.shape[1]

    def start():
        # as the Gateway does before every instance: a load may evict the
        # model's own resident leaves, which go once its instance finishes
        engine.load(model_id)
        return engine.start_instance(model_id)

    def prefill_once():
        inst = start()
        inst.prefill(batch)
        torch.cuda.synchronize()
        inst.finish()

    prefill_once()  # the first call of a fresh tree sets up what it needs
    inst = start()
    prefill_s = _timed(lambda: inst.prefill(batch))
    inst.finish()
    inst = start()
    state = {"tok": greedy(inst.prefill(batch))}

    def run_steps():
        for _ in range(steps):
            state["tok"] = greedy(inst.decode(state["tok"]))

    run_steps()  # a fresh key's eager step and capture
    step_s = _timed(run_steps) / steps
    inst.finish()
    # one profiled session: a prefill (K2) and `steps` replays (K1) after it
    with Profiled() as p:
        inst = start()
        state["tok"] = greedy(inst.prefill(batch))
        torch.cuda.synchronize()
        steps_ns = time.perf_counter_ns()
        run_steps()
        torch.cuda.synchronize()
        inst.finish()
    k2 = p.kernel_seconds(K2_KERNEL)
    k1 = p.kernel_seconds(K1_KERNEL) / steps
    # the replays' alone, whichever path the prefill's experts take
    experts = sum(p.kernel_seconds(n, steps_ns) for n in MOE_KERNELS) / steps
    # the timed steps attend to S + steps + 1 ... S + 2 steps keys, the
    # profiled ones to S + 1 ... S + steps
    return StepReading(model_id, S, prefill_s, k2, step_s, k1, S + steps + (steps + 1) / 2, steps,
                       experts)

