"""Roofline analysis of a step traced on a production mesh (port of
`repro/roofline/analysis.py`).

The reference walks XLA's optimized HLO, which has no PyTorch counterpart.
Here `CostCounter` is a `TorchDispatchMode` run around one call of a step
with the step's arguments placed as DTensors on the production mesh
(`launch.dryrun`).  It returns ``NotImplemented`` for every
op on DTensors, so DTensor desugars each into the ops it runs on this
rank's local shards, and the counter sees those: their shapes are the
per-chip shapes, and the collectives DTensor issues (redistributions,
partial-sum reductions) are local functional-collective calls.  The
shards are ``meta`` tensors (shapes only), so nothing is executed.  Ops on
`FakeTensor`s are DTensor's own propagation of global shapes, which it
runs under a `FakeTensorMode` of its own, and are not counted.

Per-op accounting (all per chip):
  matmuls    mm, bmm, addmm, baddbmm and the port's kernel operators
             (``repro_torch::flash_attention``, ``::paged_attention``),
             flops from `torch.utils.flop_counter`'s formulas on the local
             shapes (the kernels register theirs);
             bytes = the two operands + the output (the reference's
             definition: an upper bound that ignores reuse in a fused
             region); a kernel's bytes are its tensor operands + output
  collective bytes = the local operand sizes of each ``_c10d_functional``
             collective (``wait_tensor`` excluded), split by kind.

The port runs Python loops where the reference scans, so every layer's ops
are counted as they run: no trip counts are inferred.

Roofline terms (seconds) against one NVIDIA H100 SXM5 80GB (700 W), from
NVIDIA's datasheet — peaks, not measurements:
  compute    = flops_per_chip / 989e12    (dense bf16 tensor cores)
  memory     = bytes_per_chip / 3.35e12   (HBM3)
  collective = collective_bytes_per_chip / 50e9  (InfiniBand NDR, 400 Gb/s
               per GPU: the slowest link a 16-wide mesh axis crosses, as it
               spans two 8-GPU NVLink nodes)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels.ops  # noqa: F401  (registers the kernels' FLOP formulas)

aten = torch.ops.aten

MATMULS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm)
KERNELS = (torch.ops.repro_torch.flash_attention, torch.ops.repro_torch.paged_attention)
# the two matrix operands of each matmul (addmm / baddbmm add a bias first)
_OPERANDS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2)}

# functional collective -> the reference's HLO collective kind
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


@dataclass
class OpCosts:
    flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)  # kind -> bytes

    def __iadd__(self, other: "OpCosts"):
        self.flops += other.flops
        self.dot_bytes += other.dot_bytes
        self.collective_bytes += other.collective_bytes
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v
        return self

    def scaled(self, k: float) -> "OpCosts":
        return OpCosts(self.flops * k, self.dot_bytes * k,
                       self.collective_bytes * k,
                       {kk: v * k for kk, v in self.collectives.items()})


class CostCounter(TorchDispatchMode):
    """Per-chip `OpCosts` of every op run under it (see the module
    docstring); `costs` accumulates across calls."""

    def __init__(self):
        super().__init__()
        self.costs = OpCosts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run it on the local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's own shape propagation, at global shapes
        packet = func._overloadpacket
        if packet in MATMULS or packet in KERNELS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            operands = ([args[i] for i in _OPERANDS[packet]] if packet in MATMULS
                        else [a for a in args if isinstance(a, torch.Tensor)])
            self.costs += OpCosts(flops=float(flops),
                                  dot_bytes=float(_nbytes(operands) + _nbytes(out)))
            return out
        ns, _, name = func._schema.name.partition("::")
        kind = COLLECTIVES.get(name) if ns == "_c10d_functional" else None
        if kind:
            nbytes = float(_nbytes(args[0]))
            self.costs += OpCosts(collective_bytes=nbytes, collectives={kind: nbytes})
        return out


# ------------------------------------------------------------------ roofline
H100 = {"flops": 989e12, "hbm": 3.35e12, "link": 50e9}


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: dict
    model_flops: float  # 6*N*D (or analytic per family), GLOBAL
    param_bytes: int
    memory_per_chip: dict  # argument / output / temp bytes of the traced step

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / H100["flops"]

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / H100["hbm"]

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / H100["link"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful model flops per second / peak, at the modeled step time."""
        if self.step_s == 0:
            return 0.0
        achieved = self.model_flops / self.chips / self.step_s
        return achieved / H100["flops"]

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_analysis": self.memory_per_chip,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for
    inference, + attention term; D = processed tokens."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention O(S^2) term (full) or O(S*W) (windowed):
    hd = cfg.resolved_head_dim
    attn_mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd(2x) vs fwd
    for kind in cfg.pattern:
        if kind == "attn":
            ctx = shape.seq_len
        elif kind == "swa":
            ctx = min(cfg.sliding_window, shape.seq_len)
        else:
            continue
        if shape.kind == "decode":
            flops += attn_mult * 4.0 * shape.global_batch * ctx * cfg.num_heads * hd
        else:
            eff = ctx if kind == "swa" else shape.seq_len / 2
            flops += (attn_mult * 4.0 * shape.global_batch * shape.seq_len
                      * eff * cfg.num_heads * hd)
    return flops


def active_params(cfg) -> float:
    """Parameters touched per token (MoE: only routed experts count)."""
    total = cfg.param_count()
    if not cfg.is_moe:
        return total
    expert_params = cfg.num_experts * 3 * cfg.d_model * cfg.expert_ff * cfg.num_layers
    active_expert = expert_params * cfg.experts_per_token / cfg.num_experts
    return total - expert_params + active_expert
