"""Training launcher (port of `repro/launch/train.py`): any assigned
architecture, on the CUDA card unless ``--device cpu`` asks for the CPU
(with no card the default raises).

Fault tolerance: checkpoints every --ckpt-every steps; relaunching with the
same --ckpt-dir resumes from the newest one.  Each step is eager PyTorch:
the loss on the plain attention route (`Model.loss`; the kernels have no
backward), `torch.autograd.grad` over every leaf, then `adamw_update`.  Each
batch goes up from pinned host memory without waiting, and the loop reads
the loss and the gradient norm from the device only on the steps it prints,
so no other step waits for the device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
      --steps 100 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model, param_count
from repro_torch.models.common import resolve_device
from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
from repro_torch.train.checkpoint import CheckpointManager, latest_step
from repro_torch.train.data import BigramStream, DataConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def make_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict[str, torch.Tensor]:
    """The model's training batch around `tokens` (B, S): the audio and VLM
    stub inputs are zeros, as in the reference's launcher."""
    B, S = tokens.shape
    dev, dt = tokens.device, cfg.torch_dtype
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                          device=dev)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((B, cfg.vision_stub_patches, cfg.d_model),
                                             dtype=dt, device=dev)
        batch["mrope_positions"] = torch.arange(S, dtype=torch.int32,
                                                device=dev).expand(3, B, S)
    return batch


def loss_and_grads(model, params, batch, *, remat: bool = False,
                   moe_impl: str = "gshard"):
    """The loss (a detached 0-d tensor) and a gradient tree like `params`
    (zeros for a leaf the loss does not reach, as `jax.grad` gives)."""
    leaves = [t.detach().requires_grad_() for _, t in flatten_params(params)]
    structure = tree_structure(params)
    loss = model.loss(tree_unflatten(structure, leaves), batch, remat=remat,
                      moe_impl=moe_impl)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(structure, list(grads))


def train_step(model, params, opt_state, batch, opt_cfg: AdamWConfig, *,
               remat: bool = False, moe_impl: str = "gshard"):
    """One step: (params, opt_state, loss, metrics), all left on the device."""
    loss, grads = loss_and_grads(model, params, batch, remat=remat, moe_impl=moe_impl)
    params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
    return params, opt_state, loss, metrics


@dataclass
class TrainRun:
    """What a run ends with: the trained state, the step it started from,
    and each printed step as (step, loss, grad norm, seconds since the
    loop began)."""

    params: Any
    opt_state: Any
    start: int
    printed: list[tuple[int, float, float, float]] = field(default_factory=list)


def train(cfg: ModelConfig, *, name: str, steps: int, seq_len: int, batch: int,
          lr: float, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          moe_impl: str = "gshard", device="cuda") -> TrainRun:
    """The launcher's loop for `cfg` (named `name` in its lines)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        max_positions=seq_len + 8, device=dev)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 10))
    opt_state = init_opt_state(params)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"{name}: {param_count(params)/1e6:.1f}M params, {n_dev} device(s)", flush=True)

    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                   global_batch=batch))
    start = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt and latest_step(ckpt_dir) is not None:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = latest_step(ckpt_dir)
        print(f"resumed from step {start}", flush=True)

    run = TrainRun(params, opt_state, start)
    t0 = time.time()
    for step in range(start, steps):
        run.params, run.opt_state, loss, metrics = train_step(
            model, run.params, run.opt_state, make_batch(cfg, data.batch(step, device=dev)),
            opt_cfg, moe_impl=moe_impl)
        if step % 10 == 0 or step == steps - 1:
            value, gnorm = float(loss), float(metrics["grad_norm"])
            wall = time.time() - t0
            run.printed.append((step, value, gnorm, wall))
            print(f"step {step:5d} loss {value:.3f} gnorm {gnorm:.2f} "
                  f"({wall/(step-start+1):.2f}s/step)", flush=True)
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": run.params, "opt": run.opt_state})
    if ckpt:
        ckpt.save(steps, {"params": run.params, "opt": run.opt_state})
        ckpt.wait()
    return run


def main(argv=None) -> TrainRun:
    """Run the launcher on `argv` (the command line when None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--moe-impl", default="gshard")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return train(cfg, name=args.arch, steps=args.steps, seq_len=args.seq_len,
                 batch=args.batch, lr=args.lr, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, moe_impl=args.moe_impl, device=args.device)


if __name__ == "__main__":
    main()
