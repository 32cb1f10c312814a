"""The faults a B 1 serving cell can have, planted under the timed path, to
show that the check sees them (`calibrate.py --faults` at a cell's size,
`test_port_bench_faults.py` at the smoke size).

  * ``token``: a token altered where it is produced (the Gateway's greedy
    pick: every pick moved to the next id);
  * ``stuck``: a decode step that returns its state unchanged (the lengths
    do not advance: every step writes and reads the same position).

Half a batch and the exchange between chips do not exist in these cells.
"""
from __future__ import annotations

import contextlib

NAMES = ("token", "stuck")


def patches(name: str) -> list[tuple[object, str, object]]:
    """(object, attribute, replacement) that plant fault `name`."""
    if name == "token":
        from repro_torch.serverless import gateway

        pick = gateway.greedy
        return [(gateway, "greedy", lambda logits: (pick(logits) + 1) % logits.shape[-1])]
    if name == "stuck":
        from repro_torch.serving.engine import Engine

        step = Engine._paged_step

        def stuck(self, model_id, params, cfg, slab, token, tables, lengths, attn_mode):
            logits, _ = step(self, model_id, params, cfg, slab, token, tables, lengths, attn_mode)
            return logits, lengths

        return [(Engine, "_paged_step", stuck)]
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def planted(name: str | None):
    """Fault `name` planted for the block (None: nothing)."""
    saved = []
    try:
        for obj, attr, new in patches(name) if name else []:
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
