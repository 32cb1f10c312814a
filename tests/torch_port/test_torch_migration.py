"""Live KV migration (DESIGN.md §16) on the port's `Engine`: tests/
test_migration.py's scenarios — handoff, copy semantics, the hardened
transfer under an injected h2d fault, no live request, a mismatched
geometry — plus a table too narrow for the snapshot.

Within the port a migrated decode replays bit for bit (`torch.equal`)
what the source computed after the snapshot.  Against the reference, with
the same weights and fed tokens: identical snapshot metadata, block tables
and migration counters, KV blobs and replayed logits within 2e-5 (fp32).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

from torch_port_helpers import close_to, max_err, paired_engines  # noqa: E402


def _cfgs():
    over = dict(num_layers=2, vocab_size=512, dtype="float32")
    return (dataclasses.replace(ref_config("llama3.2-1b").smoke(), **over),
            dataclasses.replace(port_config("llama3.2-1b").smoke(), **over))


def _prompt(B=1, S=8):
    return np.random.default_rng(11).integers(1, 500, (B, S)).astype(np.int32)


def _engines(n=2, faults=None, **kw):
    engs = []
    for i in range(n):
        e = Engine(256 << 20, engine_id=f"eng{i}", faults=faults, device="cpu", **kw)
        e.register("m", _cfgs()[1])
        engs.append(e)
    return engs


def _start_decode(eng, steps=3):
    """Load, prefill, and advance `steps` decode steps; returns
    (instance, next_token)."""
    eng.load("m")
    inst = eng.start_instance("m")
    tok = inst.prefill({"tokens": torch.from_numpy(_prompt())}).argmax(-1).to(torch.int32)
    for _ in range(steps):
        tok = inst.decode(tok).argmax(-1).to(torch.int32)
    return inst, tok


def _window(inst, mig, tok, k):
    """The source decodes `k` tokens after the snapshot, recording each fed
    token into the replay window; returns (logits per step, next token)."""
    out = []
    for _ in range(k):
        mig.replay.append(int(tok[0]))
        logits = inst.decode(tok)
        out.append(logits.clone())
        tok = logits.argmax(-1).to(torch.int32)
    return out, tok


def test_migrated_decode_is_bit_identical():
    src, dst = _engines()
    inst, tok = _start_decode(src)
    mig = src.migrate_out("m", "seq0")
    assert src.migrated_out == 1
    assert mig.nbytes() == mig.k_blob.nbytes + mig.v_blob.nbytes == src.migration_bytes > 0
    assert all(p is None for p in mig.snap.pages) and mig.snap.seq_len == 8 + 3
    window, tok = _window(inst, mig, tok, 4)

    inst2, replayed = dst.migrate_in(mig)
    assert dst.migrated_in == 1 and len(replayed) == 4
    for got, want in zip(replayed, window):
        assert torch.equal(got, want)
    # beyond the window the replica and the control stay in lockstep
    tok2 = replayed[-1].argmax(-1).to(torch.int32)
    assert torch.equal(tok2, tok)
    for _ in range(3):
        l1, l2 = inst.decode(tok), inst2.decode(tok2)
        assert torch.equal(l1, l2)
        tok, tok2 = l1.argmax(-1).to(torch.int32), l2.argmax(-1).to(torch.int32)
    inst.finish()
    assert src.store.pool.free_bytes() > 0
    inst2.finish()
    src.close(), dst.close()


def test_snapshot_window_is_isolated_from_source_progress():
    """The blob is a device→host COPY: source steps after migrate_out must
    not change it, across a block boundary (block_tokens=16)."""
    src, dst = _engines()
    inst, tok = _start_decode(src)
    mig = src.migrate_out("m", "seq0")
    k0, v0 = mig.k_blob.clone(), mig.v_blob.clone()
    _window(inst, mig, tok, 6)
    assert torch.equal(mig.k_blob, k0) and torch.equal(mig.v_blob, v0)
    inst2, replayed = dst.migrate_in(mig)
    assert len(replayed) == 6
    inst.finish(), inst2.finish()
    src.close(), dst.close()


def test_migrate_in_rides_hardened_transfer():
    """The KV blobs go through the ChunkedTransfer retry path model loads
    use: an injected h2d chunk error is retried and counted, and the replay
    still reproduces the source bit for bit."""
    faults = FaultInjector()
    src, dst = _engines(faults=faults)
    inst, tok = _start_decode(src)
    mig = src.migrate_out("m", "seq0")
    window, _ = _window(inst, mig, tok, 2)
    dst.load("m")  # weights land first; the NEXT h2d chunks are the KV
    retries0 = dst.fault_summary()["h2d_retries"]
    faults.arm((FaultSpec("h2d.chunk", at=(0,), mode="error"),))
    inst2, replayed = dst.migrate_in(mig)
    assert dst.fault_summary()["h2d_retries"] == retries0 + 1
    for got, want in zip(replayed, window):
        assert torch.equal(got, want)
    inst.finish(), inst2.finish()
    src.close(), dst.close()


def test_migrate_out_requires_live_paged_request():
    (src,) = _engines(1)
    src.load("m")
    with pytest.raises(ValueError):
        src.migrate_out("m", "seq0")  # no live instance holds the request
    src.close()


@pytest.mark.parametrize("target", ["block_tokens", "max_blocks"])
def test_restore_refuses_what_the_target_cannot_hold(target):
    """A different block size (the snapshot's geometry) or a block table too
    narrow for the snapshot's blocks raises instead of shearing pages."""
    (src,) = _engines(1)
    inst, _ = _start_decode(src)
    mig = src.migrate_out("m", "seq0")
    if target == "block_tokens":
        (dst,) = _engines(1, block_tokens=8)
        with pytest.raises(ValueError, match="geometry"):
            dst.migrate_in(mig)
    else:
        (dst,) = _engines(1, block_tokens=4)  # 11 tokens: 3 blocks of 4
        (src4,) = _engines(1, block_tokens=4)
        inst4, _ = _start_decode(src4)
        with pytest.raises(ValueError, match="caps at 2"):
            dst.migrate_in(src4.migrate_out("m", "seq0"), max_blocks_per_seq=2)
        inst4.finish(), src4.close()
    inst.finish()
    src.close(), dst.close()


def test_migration_matches_reference():
    """The reference and the port, each migrating between two engines of its
    own over the same weights and fed tokens: equal snapshot metadata,
    tables and counters; blobs and replayed logits within 2e-5."""
    rc, pc = _cfgs()
    (rsrc, psrc, _), (rdst, pdst, _) = (paired_engines({"m": (rc, pc, 9)}),
                                       paired_engines({"m": (rc, pc, 9)}))
    toks = _prompt()
    rsrc.load("m"), psrc.load("m")
    ri = rsrc.start_instance("m", attn_mode="ref")
    pi = psrc.start_instance("m")
    rl = ri.prefill({"tokens": jnp.asarray(toks)})
    pl = pi.prefill({"tokens": torch.from_numpy(toks)})
    for _ in range(4):  # the reference's greedy tokens drive both
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rl, pl = ri.decode(jnp.asarray(tok)), pi.decode(torch.from_numpy(tok))
        assert close_to(pl, rl, "float32")
    rmig, pmig = rsrc.migrate_out("m", "seq0"), psrc.migrate_out("m", "seq0")
    for f in ("req", "seq_len", "block_tokens", "kv_bytes_per_token", "pages"):
        assert getattr(pmig.snap, f) == getattr(rmig.snap, f), f
    assert close_to(pmig.k_blob, rmig.k_blob, "float32")
    assert close_to(pmig.v_blob, rmig.v_blob, "float32")
    assert (psrc.migrated_out, psrc.migration_bytes) == (rsrc.migrated_out, rsrc.migration_bytes)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rmig.replay.append(int(tok[0])), pmig.replay.append(int(tok[0]))
        rl, pl = ri.decode(jnp.asarray(tok)), pi.decode(torch.from_numpy(tok))
    rdst.load("m"), pdst.load("m")
    ri2, rrep = rdst.migrate_in(rmig, attn_mode="ref")
    pi2, prep = pdst.migrate_in(pmig)
    assert np.array_equal(pi2._tables_np, ri2._tables_np)
    assert np.array_equal(pi2._host_lens, ri2._host_lens)
    assert list(pi2.kv.block_tables["seq0"]) == list(ri2.kv.block_tables["seq0"])
    assert (pdst.migrated_in, pdst.store.free_bytes()) == (rdst.migrated_in,
                                                           rdst.store.free_bytes())
    for got, want in zip(prep, rrep):
        assert close_to(got, want, "float32"), max_err(got, want)
    for e in (ri, pi, ri2, pi2):
        e.finish()
    for e in (rsrc, psrc, rdst, pdst):
        e.close()
