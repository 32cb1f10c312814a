"""The rate sweep behind a cell's arrival rate (run once, on the card).

    python3 port_bench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates r1,r2,...

Runs the cell at each offered rate, one after another in this process, and
prints per rate the mean Queue phase of the window's first and second
halves and its slope over the window (s of queue per request): a queue that
grows through the window means the rate is past what the card sustains.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    from pbench import cell

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    cache = {}  # one seed: the weights are drawn once
    for rate in [float(r) for r in args.rates.split(",")]:
        seen = []
        out = cell.run(HERE.parent, args.workload, args.seed, args.seconds, False,
                       t_start=time.perf_counter(), traffic={"rate_per_s": rate},
                       weights_cache=cache,
                       log=lambda m: (seen.append(m) if m.startswith("request ") else log(m)))
        q = [float(m.split("queue=")[1].split()[0]) for m in seen if "queue=" in m]
        half = len(q) // 2
        n = len(q)
        xbar = (n - 1) / 2
        slope = (sum((i - xbar) * (v - sum(q) / n) for i, v in enumerate(q))
                 / max(sum((i - xbar) ** 2 for i in range(n)), 1e-9))
        print(json.dumps({"rate_per_s": rate, "requests": n,
                          "queue_first_half_s": sum(q[:half]) / max(half, 1),
                          "queue_second_half_s": sum(q[half:]) / max(n - half, 1),
                          "queue_slope_s_per_request": slope, "correct": out["correct"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
