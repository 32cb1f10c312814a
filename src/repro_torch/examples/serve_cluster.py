"""Serve a real-world-style trace on a simulated 8-worker cluster and compare
Tangram against the SLLM-CM baseline (the paper's Fig. 13 setting; port of
`examples/serve_cluster.py`).

The cluster simulator is the cost plane: it runs on the host.  ``--device``
only checks, as every entry point of the port does, that the card is there
(``--device cpu`` asks for none).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--workers 8] [--rps 0.8]
"""
import argparse
import statistics as st

from repro_torch.core import (POLICIES, ClusterSim, PAPER_MODELS, generate_trace,
                              summarize)
from repro_torch.models.common import resolve_device


def main(argv=None):
    """Returns {policy: `summarize` row} in the printed order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--rps", type=float, default=0.8)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--locality", default="L3", choices=["L1", "L2", "L3", "L4"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    trace = generate_trace(n_requests=args.requests, locality=args.locality,
                           mean_interarrival=1.0 / args.rps, seed=21,
                           max_output_tokens=128)
    print(f"trace: {args.requests} requests, {args.rps} rps, {args.locality} "
          f"locality, {args.workers} workers\n")
    print(f"{'policy':12s} {'mean TTFT':>10s} {'p99 TTFT':>10s} {'cold load':>10s} "
          f"{'warm%':>6s} {'join%':>6s} {'reuse%':>7s} {'GB moved':>9s}")
    rows = {}
    for pol in ["sllm", "sllm-c", "sllm-cm", "tangram", "tangram-conc"]:
        sim = ClusterSim(PAPER_MODELS, POLICIES[pol], n_workers=args.workers,
                         seed=5)
        res = sim.run(trace)
        s = rows[pol] = summarize(res)
        cold = [r for r in res if not r.warm]
        cold_load = st.fmean(r.load_phase for r in cold) if cold else 0.0
        moved = sum(r.bytes_transferred for r in res) / 1e9
        print(f"{pol:12s} {s['ttft_mean']:9.2f}s {s['ttft_p99']:9.2f}s "
              f"{cold_load:9.2f}s {100*s['warm_frac']:5.0f}% "
              f"{100*s['joined_frac']:5.0f}% "
              f"{100*s['reuse_frac_mean']:6.0f}% {moved:9.1f}")
    return rows


if __name__ == "__main__":
    main()
