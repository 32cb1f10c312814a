"""Serve batched requests through the real data plane: Unified Memory Pool,
ElasticKV block tables, and the E-Attention paged kernel (port of
`examples/serve_engine.py`; K1 on the card, its plain version on the CPU).

Shows the block tables growing on demand as decode proceeds — the paper's
on-demand KV allocation — and verifies paged decode against the dense path
(the model's ring-cache decode on the same weights, within 5e-2 of the
logits' scale, tests/test_engine.py's bf16 bound).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_engine [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine

TOL = 5e-2  # bf16 logits, relative to their scale (at least 1)


def main(argv=None):
    """Returns (block-table lengths after the prefill, the largest
    paged-vs-dense logit difference over its bound)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("yi-9b").smoke()  # GQA arch through the paged path
    engine = Engine(capacity_bytes=512 * 1024 * 1024, device=args.device)
    engine.register("yi", cfg)
    engine.load("yi")

    inst = engine.start_instance("yi", num_pages=128)
    model = build_model(cfg)
    B, S, steps = 4, 40, 24
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B,
                                kind="prefill")
    batch = model.make_batch(torch.Generator().manual_seed(7), shape, device=args.device)

    logits = inst.prefill(batch)
    tables = {r: len(t) for r, t in inst.kv.block_tables.items()}
    print(f"prefill: {B} requests x {S} tokens")
    print(f"  block tables: "
          f"{{req: len(t) for req, t in list(inst.kv.block_tables.items())}} = "
          f"{tables}")

    # the dense path on the engine's own weights
    params = engine.params_of("yi")
    _, ring = model.prefill(params, batch, cache_cap=S + steps)
    worst = 0.0
    tok = logits.argmax(-1).to(torch.int32)
    for step in range(steps):
        logits = inst.decode(tok)
        dense, ring = model.decode(params, tok, torch.full((B,), S + step, dtype=torch.int32,
                                                           device=tok.device), ring)
        scale = max(1.0, float(dense.float().abs().max()))
        worst = max(worst, float((logits.float() - dense.float()).abs().max()) / scale)
        tok = logits.argmax(-1).to(torch.int32)
        if step % 8 == 7:
            kv = inst.kv
            print(f"  step {step+1:2d}: seq_len={int(inst._host_lens[0])}, "
                  f"blocks/seq={len(kv.block_tables['seq0'])}, "
                  f"pool_allocs={kv.stats.pool_allocs}, "
                  f"freelist_allocs={kv.stats.freelist_allocs}, "
                  f"kv_reserved={kv.reserved_bytes()/1e6:.2f} MB")
    print(f"paged vs dense decode: max |diff| / scale = {worst:.2e} (bound {TOL:.0e})")
    if worst > TOL:
        raise SystemExit(f"paged decode disagrees with the dense path: {worst:.3e} > {TOL}")

    print(f"\npool before finish: free={engine.store.free_bytes()/1e6:.1f} MB")
    inst.finish()
    print(f"pool after finish:  free={engine.store.free_bytes()/1e6:.1f} MB "
          f"(KV regions returned collectively; weights retained for reuse)")

    rep = engine.load("yi")
    print(f"reload: {rep.reuse_fraction:.0%} reused, "
          f"{rep.bytes_transferred} bytes transferred")
    engine.close()
    return tables, worst


if __name__ == "__main__":
    main()
