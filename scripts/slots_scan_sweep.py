"""The two layouts of `_slots`' one-hot (`models/layers._running_counts`):
(pairs, experts), whose cumsum scans the experts' columns one row at a
time, and (experts, pairs), whose cumsum runs along the contiguous axis.
Device time of one call of each, replayed from a CUDA graph as in a decode
step, at the pair counts of decode steps and of prompts, for the expert
counts of DeepSeek-V2-Lite (64), qwen3-moe (128) and mixtral (8).  Both
give the same integers (checked first).  The evidence for
the layout rule in `layers._slots`: (experts, pairs) from half as many
pairs as experts.  Needs one CUDA card:

    python3 scripts/slots_scan_sweep.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

EXPERTS = (8, 64, 128)
PAIRS = (2, 6, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 98304)
CALLS, REPLAYS = 20, 10


def graph_ms(fn) -> float:
    """Device time of one call of `fn`, from replays of a graph of CALLS calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * CALLS)


def main() -> int:
    import torch

    from repro_torch.models.layers import _running_counts

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(dev))
    for E in EXPERTS:
        faster_inner = []
        for N in PAIRS:
            flat_e = torch.randint(0, E, (N,), generator=gen, device=dev)
            outer = _running_counts(flat_e, E, inner=False)
            assert torch.equal(outer, _running_counts(flat_e, E, inner=True)), (E, N)
            ms = {inner: graph_ms(lambda i=inner: _running_counts(flat_e, E, i))
                  for inner in (False, True)}
            faster_inner.append(ms[True] < ms[False])
            print(f"[slots] E {E} pairs {N}: (pairs, E) {ms[False] * 1e3:.2f} us, "
                  f"(E, pairs) {ms[True] * 1e3:.2f} us, ratio {ms[True] / ms[False]:.3f}", flush=True)
        # the least pair count from which the (E, pairs) layout is faster at every larger one
        k = len(PAIRS)
        while k > 0 and faster_inner[k - 1]:
            k -= 1
        print(f"[slots] E {E}: (E, pairs) faster from {PAIRS[k] if k < len(PAIRS) else None} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
