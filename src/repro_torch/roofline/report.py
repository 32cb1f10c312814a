"""Render EXPERIMENTS.md roofline tables from dryrun_results.json.

Usage: PYTHONPATH=src python -m repro.roofline.report [path/to/dryrun_results.json]
Prints markdown to stdout (EXPERIMENTS.md embeds the output).
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.1f}"


def single_pod_table(results: dict) -> str:
    rows = []
    hdr = ("| arch | shape | bottleneck | compute (ms) | memory (ms) | "
           "collective (ms) | useful FLOPs ratio | roofline frac | "
           "HLO TFLOP/chip | coll GB/chip | temp GB/chip |")
    sep = "|" + "---|" * 11
    rows.append(hdr)
    rows.append(sep)
    for key in sorted(results):
        v = results[key]
        if not v.get("ok") or v.get("skipped") or v.get("mesh") != "single":
            continue
        if key.count("|") > 2:  # tagged perf-variant rows live in §Perf
            continue
        t = v["memory_analysis"].get("temp_bytes")
        rows.append(
            f"| {v['arch']} | {v['shape']} | **{v['bottleneck']}** | "
            f"{v['compute_s']*1e3:.1f} | {v['memory_s']*1e3:.1f} | "
            f"{v['collective_s']*1e3:.1f} | {v['useful_flops_ratio']:.2f} | "
            f"{v['roofline_fraction']:.3f} | "
            f"{v['hlo_flops_per_chip']/1e12:.2f} | "
            f"{v['collective_bytes_per_chip']/1e9:.2f} | {fmt_bytes(t)} |")
    return "\n".join(rows)


def multi_pod_table(results: dict) -> str:
    rows = ["| arch | shape | compile (s) | args GB/chip | temp GB/chip | "
            "coll GB/chip |", "|" + "---|" * 6]
    for key in sorted(results):
        v = results[key]
        if not v.get("ok") or v.get("skipped") or v.get("mesh") != "multi":
            continue
        if key.count("|") > 2:
            continue
        ma = v["memory_analysis"]
        rows.append(
            f"| {v['arch']} | {v['shape']} | {v['compile_s']} | "
            f"{fmt_bytes(ma.get('argument_bytes'))} | "
            f"{fmt_bytes(ma.get('temp_bytes'))} | "
            f"{v['collective_bytes_per_chip']/1e9:.2f} |")
    return "\n".join(rows)


def skipped_table(results: dict) -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for key in sorted(results):
        v = results[key]
        if v.get("skipped"):
            arch, shape, _ = key.split("|")
            rows.append(f"| {arch} | {shape} | {v['reason']} |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    print("### Single-pod (16x16 = 256 chips) roofline baselines\n")
    print(single_pod_table(results))
    print("\n### Multi-pod (2x16x16 = 512 chips) compile pass\n")
    print(multi_pod_table(results))
    print("\n### Documented skips\n")
    print(skipped_table(results))


if __name__ == "__main__":
    main()
