"""The readings the correctness limit of a cell is set from (run on the card).

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> --seeds s1,s2,... [--faults stuck,token]

For each seed, one run of the cell (a short window at the cell's own load
and sizes), its check, and beside it the control: the plain reference in
float8 e4m3 in the program's place, read over the same prompts and served
tokens.  With `--faults`, the seed's weights then serve the same window
again with each fault of `pbench/faults.py` planted under the timed path,
to read what the check sees of it at the cell's size.  Prints one JSON line
a run: every number the check can compare, of the program
(`max_logit_gap`, ...) and, without a fault, of the control
(`max_control_gap`, ...).  The benchmark's own runs never run the control.
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    from pbench import cell, faults

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    planted = [f for f in args.faults.split(",") if f]
    for seed in [int(s) for s in args.seeds.split(",")]:
        cache = {}  # this seed's weights, for its faulted runs
        for fault in [None, *planted]:
            with faults.planted(fault):
                out = cell.run(HERE.parent, args.workload, seed, args.seconds, False,
                               t_start=time.perf_counter(), control=fault is None,
                               readings=True, weights_cache=cache, log=log)
            print(json.dumps({"seed": seed, "fault": fault, "correct": out["correct"],
                              "attempted": out["attempted"], **out["readings"]}), flush=True)


if __name__ == "__main__":
    main()
