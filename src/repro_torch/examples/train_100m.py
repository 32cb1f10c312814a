"""End-to-end training example: ~100M-parameter llama-family model on the
synthetic bigram pipeline, with checkpoint/restore fault tolerance (port of
`examples/train_100m.py`).

Demonstrates the full substrate: model zoo config -> data pipeline -> AdamW ->
train step -> async checkpointing -> (simulated) crash -> elastic
restore -> loss continues from where it left off.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] [--device cpu]
(Loss should drop from ~ln(V)=9.0 toward the bigram entropy floor
~ln(4)=1.39.)
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import train_step
from repro_torch.models import build_model, param_count
from repro_torch.models.common import resolve_device
from repro_torch.train.checkpoint import CheckpointManager, latest_step
from repro_torch.train.data import BigramStream, DataConfig
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def main(argv=None):
    """Returns the printed (run tag, step, loss) rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--crash-at", type=int, default=150,
                    help="simulate a failure at this step, then restore")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_100m"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    # ~100M llama3-style config (scaled-down assigned arch)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"),
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=8192, tie_embeddings=True)
    model = build_model(cfg)

    def init():
        return model.init(torch.Generator(device=dev).manual_seed(0), device=dev)

    params = init()
    print(f"model: {param_count(params)/1e6:.1f}M params")

    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                   global_batch=16, branching=4))
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=30)
    opt_state = init_opt_state(params)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    printed = []

    def run_range(params, opt_state, start, end, tag):
        for step in range(start, end):
            tokens = data.batch(step, device=dev)
            params, opt_state, loss, _ = train_step(model, params, opt_state,
                                                    {"tokens": tokens}, opt_cfg)
            if step % 25 == 0 or step == end - 1:
                printed.append((tag, step, float(loss)))
                print(f"[{tag}] step {step:4d} loss {printed[-1][2]:.3f}")
            if step and step % 50 == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        return params, opt_state

    t0 = time.time()
    params, opt_state = run_range(params, opt_state, 0, args.crash_at, "run1")
    ckpt.save(args.crash_at, {"params": params, "opt": opt_state})
    ckpt.wait()

    print(f"\n-- simulated node failure at step {args.crash_at}; "
          f"restoring from {args.ckpt_dir} --\n")
    del params, opt_state  # the 'crash'

    fresh_params = init()
    fresh_opt = init_opt_state(fresh_params)
    restored = ckpt.restore_latest({"params": fresh_params, "opt": fresh_opt})
    start = latest_step(args.ckpt_dir)
    params, opt_state = restored["params"], restored["opt"]
    print(f"restored step {start}")

    params, opt_state = run_range(params, opt_state, start, args.steps, "run2")
    print(f"\ndone in {time.time()-t0:.0f}s; entropy floor = "
          f"{data.entropy_floor():.2f} nats")
    return printed


if __name__ == "__main__":
    main()
