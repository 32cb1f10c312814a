"""Quickstart: Tangram in 60 seconds (port of `examples/quickstart.py`).

Registers two small models on one engine, serves them alternately, and shows
the cold-start -> warm-reuse transition that is the paper's core result:
the second load of a model transfers ZERO bytes because its tensors were
retained in the Unified Memory Pool.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine


def main(argv=None):
    """Returns the three loads' `LoadReport`s (cold, switch, warm)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # two assigned architectures, reduced to laptop scale
    cfg_a = get_config("llama3.2-1b").smoke()
    cfg_b = get_config("deepseek-7b").smoke()

    engine = Engine(capacity_bytes=256 * 1024 * 1024, device=args.device)
    engine.register("llama", cfg_a)
    engine.register("deepseek", cfg_b)

    print("== cold start: llama ==")
    cold = engine.load("llama")
    print(f"  transferred {cold.bytes_transferred/1e6:.1f} MB, "
          f"reuse={cold.reuse_fraction:.0%}, modeled load {cold.load_seconds*1e3:.1f} ms")

    # serve a short batch
    inst = engine.start_instance("llama", num_pages=64)
    model = build_model(cfg_a)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2,
                                kind="prefill")
    batch = model.make_batch(torch.Generator().manual_seed(0), shape, device=args.device)
    logits = inst.prefill(batch)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(8):
        logits = inst.decode(out[-1])
        out.append(logits.argmax(-1).to(torch.int32))
    print(f"  generated tokens (batch 0): {[int(t[0]) for t in out]}")
    inst.finish()  # instance ends; tensors STAY in the pool

    print("== switch: deepseek (evicts llama tensors only as needed) ==")
    switch = engine.load("deepseek")
    print(f"  transferred {switch.bytes_transferred/1e6:.1f} MB, "
          f"pool free {engine.store.free_bytes()/1e6:.1f} MB")
    engine.release("deepseek")

    print("== warm start: llama again ==")
    warm = engine.load("llama")
    print(f"  transferred {warm.bytes_transferred/1e6:.1f} MB, "
          f"reuse={warm.reuse_fraction:.0%} -> load time "
          f"{warm.load_seconds*1e3:.1f} ms (was cold)")
    print("pool:", engine.store.pool)
    engine.close()
    return cold, switch, warm


if __name__ == "__main__":
    main()
