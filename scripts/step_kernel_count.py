"""Kernels in one replayed paged decode step, counted by torch.profiler.

    python3 scripts/step_kernel_count.py [--models deepseek-7b,qwen3-moe-30b-a3b]
                                         [--steps 8] [--prompt 512]

For each model (at full width; qwen3-moe-30b-a3b at 12 of its 48 layers,
as the benchmark's `moe-duo` configuration runs it; weights drawn on the
card as `chip_smoke.draw_weights` draws them): a graphed `Engine`, a B 1
prefill of `--prompt` tokens, two decode steps (the key's eager first call
and its capture), then `--steps` replays under the profiler.  Prints one
JSON line a model: kernels a step, device time a step, and the kernels a
step of each name (the 12 most frequent).  It uses only the engine's
public calls, so the same command counts any tree of the port: run it in
two checkouts in one call to compare them.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MOE_LAYERS = 12


def count(model: str, steps: int, prompt: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.serverless.gateway import make_prefill_batch
    from repro_torch.serving.engine import Engine

    cfg = get_config(model)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
    tree = chip_smoke.draw_weights(cfg, 0)
    eng = Engine(40 << 30, device="cuda")
    eng.register(model, cfg, init_fn=lambda: tree)
    eng.load(model)
    inst = eng.start_instance(model)
    tok = inst.prefill(make_prefill_batch(eng, model, prompt, 0)).argmax(-1).to(torch.int32)
    for _ in range(2):  # eager first call, capture
        tok = inst.decode(tok).argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    replays = eng.step_graphs.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = inst.decode(tok).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
    assert eng.step_graphs.replays - replays == steps, "every profiled step is a replay"
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter(e.name for e in kernels)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    inst.finish()
    eng.close()
    del tree
    torch.cuda.empty_cache()
    return {"model": model, "layers": cfg.num_layers, "prompt": prompt, "steps": steps,
            "kernels_a_step": len(kernels) / steps, "device_ms_a_step": busy_ms,
            "top": {n[:90]: c / steps for n, c in by_name.most_common(12)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", default="deepseek-7b,qwen3-moe-30b-a3b")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--prompt", type=int, default=512)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    chip_smoke.setup()
    for model in args.models.split(","):
        print(json.dumps(count(model, args.steps, args.prompt)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
