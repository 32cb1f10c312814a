"""Serving launcher: a Tangram engine worker over the assigned architectures
(port of `repro/launch/serve.py`).

Registers the requested models, then serves a model-switching request
sequence, printing the Tangram load report (reuse fraction, bytes moved) and
TTFT phases per request — the single-worker real-data-plane version of the
cluster simulation.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --models llama3.2-1b,deepseek-7b --smoke --requests 8

With ``--trace {poisson,diurnal,burst}`` the launcher replays a synthesized
serverless workload through the control-plane Gateway instead of the
round-robin sequence (DESIGN.md §13): arrivals follow the chosen process,
``--keep-alive-policy`` (zero | fixed[:T] | adaptive[:P]) drives per-model
scale-to-zero / retain on the trace clock, and the run ends with cold-start
rate + TTFT percentile summaries from the metrics sink.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --models llama3.2-1b,deepseek-7b --trace poisson --requests 8 \
      --keep-alive-policy adaptive

With ``--n-engines N`` (N >= 2, requires ``--trace``) the trace replays
through the multi-engine ``FleetGateway`` instead (DESIGN.md §14): each
engine owns its own device pool + host Model Store, arrivals route by the
shared eq3+queue affinity score, and ``--prewarm`` additionally promotes
models AHEAD of their predicted re-arrivals when the cost/benefit check
passes (adaptive keep-alive only — fixed TTLs carry no arrival model).

``--chaos`` (requires ``--trace``) arms the seeded chaos schedule
(DESIGN.md §15): per-engine h2d stalls and a prefetch-worker death, plus an
engine crash/recover on the fleet path; the run ends with the per-engine
fault ledger and (fleet) the dropped/redriven counts.

The engines run on the CUDA card unless ``--device cpu`` asks for the CPU;
with no card the default raises.  ``--smoke`` is always on, as in the
reference (its flag is ``store_true`` with ``default=True``).  Prefill and
decode walls end when the device has produced the first and the last token
(`serverless.gateway.generate`).
"""
from __future__ import annotations

import argparse
import itertools
import time

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.serverless.gateway import generate
from repro_torch.serving.engine import Engine


def _print_ttft_breakdown(records):
    """Per-phase TTFT breakdown table over a replay's TTFTRecords: where
    the time-to-first-token actually went, phase by phase (DESIGN.md §18)."""
    from repro_torch.core.trace import percentile

    n = len(records)
    if n == 0:
        return
    ttft_total = sum(r.ttft for r in records) or 1e-12
    print("TTFT breakdown (decode excluded):")
    print(f"  {'phase':8s} {'mean':>9s} {'p95':>9s} {'share':>7s}")
    for phase in ("queue", "init", "load", "profile", "prefill"):
        xs = sorted(getattr(r, f"{phase}_s") for r in records)
        total = sum(xs)
        print(f"  {phase:8s} {total / n:8.3f}s {percentile(xs, 0.95):8.3f}s "
              f"{total / ttft_total:6.1%}")
    print(f"  {'ttft':8s} {ttft_total / n:8.3f}s "
          f"{percentile(sorted(r.ttft for r in records), 0.95):8.3f}s "
          f"{1.0:6.1%}")


def _export_obs(tracer, args, extra_summary=None):
    """Write --trace-out (Perfetto JSON) and --metrics-out (unified metrics
    snapshot) from the run's tracer."""
    if tracer is None:
        return
    if args.trace_out:
        from repro_torch.obs import write_chrome_trace

        write_chrome_trace(tracer.events(), args.trace_out)
        print(f"trace written: {args.trace_out} "
              f"({len(tracer.events())} events — load at ui.perfetto.dev)")
    if args.metrics_out:
        import json

        from repro_torch.obs import MetricsRegistry, obs_stats

        reg = MetricsRegistry()
        if extra_summary:
            reg.absorb(extra_summary, prefix="summary")
        snap = reg.snapshot().as_dict()
        snap["obs"] = obs_stats(tracer)
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        print(f"metrics written: {args.metrics_out}")


def main(argv=None):
    """Run the launcher on `argv` (the command line when None); returns the
    engines it served with, closed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="llama3.2-1b,deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--pool-mb", type=int, default=512)
    ap.add_argument("--host-cache-mb", type=int, default=None,
                    help="bound the host Model Store tier (spills beyond)")
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    help="disable the next-request prefetch hint (§12)")
    from repro_torch.serverless.workload import ARRIVALS

    ap.add_argument("--trace", default=None, choices=list(ARRIVALS),
                    help="replay a synthesized serverless workload through "
                         "the control-plane Gateway (§13)")
    ap.add_argument("--keep-alive-policy", default="fixed:60",
                    help="zero | fixed[:T] | adaptive[:P] (with --trace)")
    ap.add_argument("--mean-interarrival", type=float, default=20.0,
                    help="trace mean inter-arrival seconds (with --trace)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--n-engines", type=int, default=1,
                    help="with --trace: route across N engines via the "
                         "FleetGateway's shared affinity score (§14)")
    ap.add_argument("--prewarm", action="store_true",
                    help="with --n-engines: promote models ahead of "
                         "predicted re-arrivals (adaptive keep-alive)")
    ap.add_argument("--chaos", action="store_true",
                    help="with --trace: arm the seeded chaos schedule "
                         "(DESIGN.md §15) — one h2d stall + one prefetch-"
                         "worker death per engine, plus an engine crash/"
                         "recover on the fleet path — and print the fault "
                         "ledger at the end")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="FILE.json",
                    help="write the run's span timeline as Chrome/Perfetto "
                         "trace-event JSON (DESIGN.md §18) — load it at "
                         "ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.json",
                    help="write the unified metrics snapshot (summary "
                         "counters + span accounting) as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (the card; raises "
                         "without one) or cpu")
    args = ap.parse_args(argv)
    if args.n_engines < 1:
        ap.error("--n-engines must be >= 1")
    if args.n_engines > 1 and args.trace is None:
        ap.error("--n-engines > 1 requires --trace (fleet replay)")
    if args.chaos and args.trace is None:
        ap.error("--chaos requires --trace (fault schedules replay on the "
                 "trace clock)")

    injectors = None
    fault_events = []
    if args.chaos:
        # seeded chaos schedule, one injector PER engine (the fleet ledger
        # sums per-engine injectors — sharing one would double-count).  The
        # launcher leaves store_keys empty: keyed store.read specs name
        # tensor fingerprints, which fig17 and tests/test_chaos.py control;
        # here the h2d stall, worker death, and fleet crash/recover fire.
        from repro_torch.core.faults import FaultInjector
        from repro_torch.serverless.workload import chaos_schedule

        specs, fault_events = chaos_schedule(seed=args.chaos_seed,
                                             n_engines=args.n_engines)
        injectors = [FaultInjector(specs=tuple(s), seed=args.chaos_seed)
                     for s in specs]

    # obs plane (DESIGN.md §18): one tracer across the engines and the
    # gateway — engine spans stamp perf_counter walls, request span
    # families ride the virtual trace clock, each on its own track
    tracer = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import FlightRecorder, Tracer

        tracer = Tracer(flight=FlightRecorder())

    names = args.models.split(",")
    host_bytes = (None if args.host_cache_mb is None
                  else args.host_cache_mb * 1024 * 1024)
    engines = [Engine(args.pool_mb * 1024 * 1024, host_cache_bytes=host_bytes,
                      engine_id=f"engine{i}",
                      faults=injectors[i] if injectors else None,
                      tracer=tracer, device=args.device)
               for i in range(args.n_engines)]
    engine = engines[0]
    cfgs = {}
    for n in names:
        cfg = get_config(n)
        if args.smoke:
            cfg = cfg.smoke()
        cfgs[n] = cfg
        for eng in engines:
            eng.register(n, cfg)

    if args.trace is not None:
        # serverless control plane (§13): synthesize the arrival process
        # over the registered models and replay it through the Gateway —
        # keep-alive decisions run on the trace clock, phase durations are
        # measured wall time
        from repro_torch.core.trace import SimModel
        from repro_torch.serverless import FleetGateway, Gateway, make_trace

        sim_models = [SimModel(n, 1e6, 1) for n in names]
        trace = make_trace(args.trace, n_requests=args.requests,
                           models=sim_models, seed=args.trace_seed,
                           mean_interarrival=args.mean_interarrival)
        if args.n_engines > 1:
            # fleet replay (§14): shared-score routing + optional pre-warm
            gw = FleetGateway(engines, keep_alive=args.keep_alive_policy,
                              prefetch=args.prefetch, prewarm=args.prewarm,
                              prompt_len=args.prompt_len,
                              gen_tokens=args.gen_tokens, tracer=tracer)
            sink = gw.run_trace(trace, faults=fault_events)
            for i, (r, d) in enumerate(zip(sink.records, gw.decisions)):
                print(f"req {i}: {r.model_id:16s} -> {d[2]} "
                      f"{'cold' if r.cold else 'warm'} "
                      f"load {r.load_s*1e3:7.1f}ms "
                      f"prefill {r.prefill_s:.2f}s")
        else:
            gw = Gateway(engine, keep_alive=args.keep_alive_policy,
                         prefetch=args.prefetch, prompt_len=args.prompt_len,
                         gen_tokens=args.gen_tokens, tracer=tracer)
            sink = gw.run_trace(trace)
            for i, r in enumerate(sink.records):
                print(f"req {i}: {r.model_id:16s} "
                      f"{'cold' if r.cold else 'warm'} "
                      f"load {r.load_s*1e3:7.1f}ms prefill {r.prefill_s:.2f}s "
                      f"decode {r.decode_s/max(args.gen_tokens,1)*1e3:.0f}ms/tok")
        s = sink.summary()
        ls = gw.lifecycle.summary()
        fleet_note = (f" engines={args.n_engines} "
                      f"prewarms={gw.prewarms} hits={gw.prewarm_hits}"
                      if args.n_engines > 1 else "")
        print(f"serverless summary: n={s['n']} "
              f"cold_rate={s['cold_start_rate']:.2f} "
              f"ttft_p50={s['ttft_p50']:.2f}s ttft_p95={s['ttft_p95']:.2f}s "
              f"expirations={int(ls['expirations'])} "
              f"policy={args.keep_alive_policy} trace={args.trace}"
              f"{fleet_note}")
        if args.chaos:
            for eng in engines:
                fs = eng.fault_summary()
                print(f"chaos[{eng.engine_id}]: injected={fs['injected']} "
                      f"h2d_stalls={fs['h2d_stalls']} "
                      f"h2d_retries={fs['h2d_retries']} "
                      f"worker_restarts={fs['worker_restarts']} "
                      f"join_failovers={fs['join_failovers']} "
                      f"quarantined={fs['store_quarantined']} "
                      f"crashes={fs['crashes']}")
            if args.n_engines > 1:
                fsum = gw.summary()
                print(f"chaos fleet: dropped={fsum['dropped_requests']} "
                      f"crashes={fsum['engine_crashes']} "
                      f"recoveries={fsum['engine_recoveries']} "
                      f"redriven={fsum['requests_redriven']}")
        _print_ttft_breakdown(sink.records)
        _export_obs(tracer, args, extra_summary=s)
        for eng in engines:
            eng.close()
        return engines

    import dataclasses
    seq = list(itertools.islice(itertools.cycle(names), args.requests))
    for i, name in enumerate(seq):
        t0 = time.time()
        rep = engine.load(name)
        load_s = time.time() - t0
        if args.prefetch and i + 1 < len(seq) and seq[i + 1] != name:
            # the launcher IS the scheduler here: the next placement is
            # already known, so hint it now — its store-tier tensors promote
            # in the background while this request prefills/decodes (§12)
            engine.prefetch(seq[i + 1])
        inst = engine.start_instance(name, num_pages=128)
        model = build_model(cfgs[name])
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.prompt_len,
                                    global_batch=2, kind="prefill")
        batch = model.make_batch(torch.Generator().manual_seed(i), shape,
                                 device=engine.device)
        prefill_s, decode_s = generate(inst, batch, args.gen_tokens)
        inst.finish()
        stats = engine.last_load
        pf = (f" prefetched={stats.bytes_prefetched/1e6:.1f}MB"
              if stats.bytes_prefetched else "")
        print(f"req {i}: {name:16s} reuse={rep.reuse_fraction:4.0%} "
              f"transferred={rep.bytes_transferred/1e6:6.1f}MB "
              f"(modeled load {rep.load_seconds*1e3:6.1f}ms, wall {load_s:.2f}s) "
              f"prefill {prefill_s:.2f}s decode {decode_s/args.gen_tokens*1e3:.0f}ms/tok "
              f"pool_free={engine.store.free_bytes()/1e6:.0f}MB{pf}")
    _export_obs(tracer, args)
    engine.close()
    return engines


if __name__ == "__main__":
    main()
