"""Synthetic token pipeline (port of `repro/train/data.py`): deterministic,
shardable, learnable.

Sequences follow a fixed random bigram chain (a vocab-sized transition
table) so small models visibly reduce loss in a few hundred steps.  The
table comes from ``np.random.default_rng(seed)`` exactly as in the
reference, so the two packages' tables are equal.  The reference draws each
batch's start tokens and successor choices from `jax.random` folds of
(seed + 1, step, shard); the port cannot reproduce those bits without JAX,
so it draws them from a CPU `torch.Generator` seeded by (seed + 1, step,
shard): any data-parallel worker regenerates its shard alone, with no host
I/O, but the port's batches are not the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4  # successors per token; lower = more learnable


class BigramStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # each token transitions to `branching` fixed successors
        self.table = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.vocab_size, cfg.branching),
                                  dtype=np.int32)

    def _generator(self, step: int, shard: int) -> torch.Generator:
        words = np.random.SeedSequence([self.cfg.seed + 1, step, shard]).generate_state(2)
        return torch.Generator().manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1,
              device="cpu") -> torch.Tensor:
        """(global_batch/num_shards, seq_len) int32 tokens for `shard`, built
        on the host.  For a CUDA `device` the host buffer is pinned and the
        copy is asynchronous, so a training loop does not wait here for the
        device to finish the step before."""
        cfg = self.cfg
        device = torch.device(device)
        b = cfg.global_batch // num_shards
        gen = self._generator(step, shard)
        tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen).numpy()
        choices = torch.randint(0, cfg.branching, (b, cfg.seq_len - 1), generator=gen).numpy()
        out = torch.empty((b, cfg.seq_len), dtype=torch.int32,
                          pin_memory=device.type == "cuda")
        host = out.numpy()
        host[:, 0] = tok
        for t in range(cfg.seq_len - 1):
            tok = self.table[tok, choices[:, t]]
            host[:, t + 1] = tok
        return out.to(device, non_blocking=True)

    def entropy_floor(self) -> float:
        """Ideal loss = log(branching) once transitions are memorized."""
        return float(np.log(self.cfg.branching))
