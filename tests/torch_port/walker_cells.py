"""Per-chip costs of the distributed steps in both packages, for the
roofline tests (`test_torch_roofline.py` for train, `test_torch_roofline_
serve.py` for prefill and decode).

Every cell is a smoke config on a 4x4 (data, model) mesh: train_4k cut to
S 256, B 8; prefill_32k and decode_32k cut to S 1024, B 8.  The reference's
costs come from its HLO walker (`make_step` + `HloModule.entry_cost()`) in
a subprocess with 16 forced host devices, the port's from
`roofline.analysis.CostCounter` in one that joined a fake process group of
16 ranks (shapes only).  The port's count also records, for each call of
the flash kernel K2, the FLOPs of the (query, key) pairs it skips: the
walker counts the dense S x S products of the reference's
`attention_dense`, K2 only the visible pairs.
"""
import json

from dist_helpers import finish, start_snippet

CUTS = {"train_4k": (256, 8), "prefill_32k": (1024, 8), "decode_32k": (1024, 8)}

REF_CELLS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import dataclasses, json, jax
from repro.configs import SHAPES, all_configs
from repro.distributed.steps import make_step
from repro.distributed.sharding import make_mesh_compat
from repro.launch.dryrun import trip_hints
from repro.roofline.analysis import HloModule

mesh = make_mesh_compat((4, 4), ("data", "model"), devices=jax.devices())
out = {}
for name, (seq, batch) in CUTS.items():
    shape = dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)
    for arch in ARCHS:
        cfg = all_configs()[arch].smoke()
        bundle = make_step(cfg, mesh, shape)
        with mesh:
            compiled = bundle.fn.lower(*bundle.args).compile()
        cost = HloModule(compiled.as_text(), trip_hints(cfg, shape)).entry_cost()
        out[f"{arch}|{name}"] = {"flops": cost.flops, "coll": cost.collective_bytes,
                                 "collectives": cost.collectives, "masked": 0}
print("RESULT" + json.dumps(out))
"""

PORT_CELLS = """
import dataclasses, json
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(16)
import torch
from torch._subclasses.fake_tensor import FakeTensor
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.steps import make_step
from repro_torch.kernels.flash_attention import visible_pairs
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.roofline.analysis import CostCounter


class Counter(CostCounter):
    # the FLOPs of the pairs each K2 call skips (what a dense S x S product
    # would add): 4 B H hd (S^2 - visible pairs), on the local shapes
    masked = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented and func._overloadpacket is torch.ops.repro_torch.flash_attention
                and not any(issubclass(t, FakeTensor) for t in types)):
            B, S, H, hd = args[0].shape
            self.masked += 4 * B * H * hd * (S * S - visible_pairs(S, args[3], args[4]))
        return out


mesh = make_mesh_compat((4, 4), ("data", "model"))
out = {}
for name, (seq, batch) in CUTS.items():
    shape = dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)
    for arch in ARCHS:
        bundle = make_step(get_config(arch).smoke(), mesh, shape)
        args = bundle.place(*bundle.args)
        counter = Counter()
        with counter:
            bundle.fn(*args)
        c = counter.costs
        out[f"{arch}|{name}"] = {"flops": c.flops, "coll": c.collective_bytes,
                                 "collectives": c.collectives, "masked": counter.masked}
print("RESULT" + json.dumps(out))
"""


def start(archs, shapes, port: bool):
    """Start one package's subprocess over `archs` x `shapes`."""
    head = f"ARCHS = {list(archs)!r}\nCUTS = {({s: CUTS[s] for s in shapes})!r}\n"
    if port:
        return start_snippet(head + PORT_CELLS)
    return start_snippet(head + REF_CELLS, {"JAX_PLATFORMS": "cpu"})


def collect(procs, timeout: int = 600) -> dict:
    """The merged results of started subprocesses."""
    out = {}
    for p in procs:
        text, _ = finish(p, timeout)
        out.update(json.loads(text.split("RESULT")[1]))
    return out


def hold(port: dict, ref: dict, key: str):
    """(a) per-chip matmul FLOPs within 10% of the walker's, K2's skipped
    pairs added back; (b) per-chip collective bytes at most 1.1x."""
    got, want = port[key], ref[key]
    flops = got["flops"] + got["masked"]
    print(f"{key}: FLOPs port {got['flops']:.0f} (+{got['masked']:.0f} masked) vs walker "
          f"{want['flops']:.0f}; collective B port {got['coll']:.0f} {got['collectives']} vs "
          f"walker {want['coll']:.0f} {want['collectives']}")
    assert abs(flops - want["flops"]) <= 0.1 * want["flops"], (flops, want["flops"])
    assert got["coll"] <= 1.1 * want["coll"], (got["coll"], want["coll"])
