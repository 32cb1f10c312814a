#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any phase fails, if no CUDA device is present, or if it is
run outside a checkout of the repository):

1. setup: the card's name and power limit, TF32 off, every CUDA kernel of
   the port built from `src/repro_torch/csrc/` (one nvcc per source, all
   started together);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a sweep of the edges of each design (fp32 /
   bf16; paged decode: lengths 0 and 1, at and +-1 around the split-KV
   boundaries, full tables, a long context, G of 1 to 16, head dim 64 /
   128; prefill: S of 1 to 512 around the 64-row tiles, sliding windows,
   non-causal, head dim 32 / 64 / 128, G of 1 / 4 / 8), with the kernel's,
   the plain version's and a PyTorch call's time beside the bound, at the
   main path's shapes and at one long shape each (`[timing]` lines: a
   4000-token conversation at batch 1, a 4096-token prompt);
3. main path at full width on llama3.2-1b (random weights from a seed):
   `Engine.register_model`, a cold then a warm `Engine.load`, prefill of 4
   prompts of lengths 512/384/200/64, 1 + 32 decode steps under
   `torch.cuda.set_sync_debug_mode("error")`, a second instance and 8 fused
   `decode_many` steps.  Launch counters are zeroed just before and read
   just after; the decode logits are then held against the same run with
   the plain paged attention (`attn_mode="ref"`), and `torch.profiler`
   splits a warm prefill and 8 decode steps by kernel (`[profile]` lines);
4. `[serverless]`: the single-engine `Gateway` at full width over
   llama3.2-1b and deepseek-7b (weights drawn once each, on the card from a
   seeded generator, kept in page-locked host memory and handed to every
   engine as its `init_fn`), one pool that holds deepseek-7b and its KV but
   not both models, a seeded Poisson trace of 10 requests (prompt 256,
   16 greedy tokens) under a fixed 10 s keep-alive: warm starts, full h2d
   cold starts and cold starts that reuse part of the model from the pool.
   Every load's bytes are checked against the model's, the first request of
   each model is held against the plain attention path, launch counts
   against the requests, and a crash must give the card's memory back;
5. `[fleet]`: `FleetGateway` over two engines on the card under the seeded
   `chaos_schedule` (an h2d stall and a prefetch-worker death per engine, a
   crash and a recovery), host tiers bounded so that released tensors
   spill to the persistent store; then the recovered engine serves a
   `Gateway` replay whose next-model hints promote spilled tensors while
   the current request runs;
6. `[launcher]`: ``python -m repro_torch.launch.serve --trace poisson
   --n-engines 2 --chaos`` at the launcher's own smoke sizes, on the card.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): the bound of each kernel is the larger of
# bytes / HBM rate and operations / peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn()` over `iters` back-to-back launches.

    A device-side spin (~50 ms) is queued ahead of the timed window, so the
    host has enqueued every launch before the first one runs: the events then
    time the device work, not the host's launch overhead (a 50 µs kernel
    launched from Python is otherwise timed at the host's pace)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def setup():
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} kernel sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "Warning")):
                log(f"[build] {name}: {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _paged_inputs(gen, dtype, B, H, K, hd, T, N, lengths, dev):
    import torch

    P = B * N + 3
    q = torch.randn((B, H, hd), generator=gen).to(dev, dtype)
    kp = torch.randn((P, T, K, hd), generator=gen).to(dev, dtype)
    vp = torch.randn((P, T, K, hd), generator=gen).to(dev, dtype)
    tables = torch.randperm(P, generator=gen)[: B * N].reshape(B, N).to(dev, torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32).to(dev)
    return q, kp, vp, tables, lens


def _check(name: str, out, ref, dt: str, desc: str) -> float:
    """Max abs error of a kernel's output against its plain version; raises
    past the tolerance."""
    err = float((out.float() - ref.float()).abs().max())
    line = f"[kernel] {name} {desc}: max_abs_err {err:.3e} (tol {TOL[dt]:g})"
    log(line)
    if not err < TOL[dt]:
        raise AssertionError(f"{name} disagrees with its plain version: {line}")
    return err


def _timing_row(name: str, label: str, dt: str, kernel, plain, library, lib_label: str,
                nbytes: int, flops: int, err: float) -> dict:
    """Kernel, plain-version and library times of one shape beside its bound,
    achieved rate and share of the bound."""
    ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    library_ms = cuda_time_ms(library)
    bound_ms, bound_by = _bound(nbytes, flops, dt)
    rate = (f"{nbytes / ms / 1e9:.3f} TB/s" if bound_by == "bytes"
            else f"{flops / ms / 1e9:.1f} TFLOP/s")
    log(f"[timing] {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{lib_label} {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
        f"achieved {rate}, {bound_ms / ms:.3f} of the bound, "
        f"{ms / library_ms:.2f}x the library call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_kernels() -> dict:
    """Every kernel against its plain version over a sweep of shapes; times
    the main-path, long-context and deepseek-7b shapes.  Returns the rows of
    the main path's and deepseek-7b's shapes, keyed (kernel, label)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import split_plan
    from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # K1: (label, dtype, B, H, K, hd, T, N, lengths).  Timed: the main path's
    # decode shape (llama3.2-1b, lengths after prefill + decode) and one long
    # conversation at batch 1.  The rest put lengths at split boundaries and
    # +-1 of them, a full table, length 0 and 1, G of 1 / 4 / 8 / 16.
    st16, _ = split_plan(64, 16)
    st32, _ = split_plan(8, 32)
    paged_cases = [
        ("main", "bfloat16", 4, 32, 8, 64, 16, 64, (545, 417, 233, 97)),
        ("long", "bfloat16", 1, 32, 8, 64, 16, 256, (4000,)),
        ("", "bfloat16", 4, 32, 8, 64, 16, 64, (st16 - 1, st16, st16 + 1, 1)),
        ("", "bfloat16", 4, 32, 8, 64, 16, 64, (2 * st16 - 1, 2 * st16, 2 * st16 + 1, 1024)),
        ("", "float32", 4, 32, 8, 64, 16, 64, (1, 17, 200, 1024)),
        ("", "float32", 4, 32, 8, 64, 16, 64, (st16 - 1, st16 + 1, 0, 3 * st16)),
        ("", "bfloat16", 4, 32, 4, 128, 16, 64, (1, 33, 513, 1000)),
        ("", "float32", 3, 32, 4, 128, 16, 32, (5, 16, 509)),
        ("", "bfloat16", 2, 16, 1, 128, 32, 4, (1, 100)),
        ("", "bfloat16", 2, 8, 8, 64, 16, 16, (st16, 256)),
        ("", "float32", 2, 8, 8, 128, 16, 16, (st16 + 1, 255)),
        ("", "float32", 3, 32, 8, 64, 32, 8, (st32 - 1, st32, 256)),
        ("", "bfloat16", 1, 32, 8, 128, 16, 256, (4096,)),
        # deepseek-7b's decode in [serverless]: MHA (G 1), hd 128, B 1, the
        # last step of a 256-token prompt and 16 greedy tokens
        ("deepseek-7b", "bfloat16", 1, 32, 32, 128, 16, 64,
         (SERVERLESS_PROMPT + SERVERLESS_GEN,)),
    ]
    for label, dt, B, H, K, hd, T, N, lengths in paged_cases:
        dtype = getattr(torch, dt)
        args = _paged_inputs(gen, dtype, B, H, K, hd, T, N, lengths, dev)
        out = ops.paged_attention(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = _check("paged_attention", out, ref, dt,
                     f"{dt} B{B} H{H} K{K} hd{hd} T{T} N{N} lengths {list(lengths)}")
        if not label:
            continue
        # yardstick only: SDPA over K/V gathered to dense beforehand (the
        # gather is not timed), masked by length
        q, kp, vp, tables, lens = args
        kd = kp[tables.long()].reshape(B, N * T, K, hd).transpose(1, 2)
        vd = vp[tables.long()].reshape(B, N * T, K, hd).transpose(1, 2)
        kd = kd.repeat_interleave(H // K, dim=1)
        vd = vd.repeat_interleave(H // K, dim=1)
        mask = (torch.arange(N * T, device=dev)[None, :] < lens[:, None].long())
        mask = mask[:, None, None, :]
        live = sum(lengths)
        nbytes = (2 * live * K * hd * kp.element_size()   # K and V rows read
                  + 2 * B * H * hd * q.element_size()     # q read, out written
                  + sum(math.ceil(n / T) for n in lengths) * 4 + B * 4)
        row = _timing_row(
            "paged_attention", f"{label} {dt} B{B} H{H} K{K} hd{hd} T{T} N{N} "
            f"lengths {list(lengths)}", dt,
            lambda: ops.paged_attention(*args), lambda: paged_attention_ref(*args),
            lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=mask),
            "sdpa on pre-gathered dense K/V", nbytes, 4 * live * H * hd, err)
        if label in ("main", "deepseek-7b"):
            # no single PyTorch call does paged attention: the gathered SDPA
            # above is printed, not reported as the library time
            rows[("paged_attention", label)] = {
                "name": "paged_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:120",
                "shape": SHAPE_NOTES[label], **row, "library_ms": None}

    # K2: (label, dtype, B, S, H, K, hd, causal, window).  Timed: the main
    # path's prefill (llama3.2-1b, 4 prompts padded to 512) and one 4k-token
    # prompt.  The rest: S at and around the 64-row tiles (1, 63, 64, 65,
    # 129, 300), windows spanning several tiles, non-causal, hd 32 / 64 /
    # 128, G of 1 / 4 / 8.
    flash_cases = [
        ("main", "bfloat16", 4, 512, 32, 8, 64, True, 0),
        ("long", "bfloat16", 1, 4096, 32, 8, 64, True, 0),
        ("", "float32", 4, 512, 32, 8, 64, True, 0),
        ("", "bfloat16", 2, 300, 32, 8, 64, True, 0),
        ("", "float32", 2, 300, 32, 4, 128, True, 64),
        ("", "bfloat16", 2, 512, 32, 4, 128, True, 64),
        ("", "float32", 1, 200, 8, 8, 64, False, 0),
        ("", "bfloat16", 2, 1, 8, 2, 64, True, 0),
        ("", "bfloat16", 2, 63, 8, 2, 64, True, 0),
        ("", "bfloat16", 2, 64, 8, 2, 64, True, 0),
        ("", "bfloat16", 2, 65, 8, 2, 64, True, 0),
        ("", "bfloat16", 2, 129, 8, 2, 128, True, 0),
        ("", "bfloat16", 2, 300, 8, 2, 64, True, 64),
        ("", "bfloat16", 1, 200, 8, 8, 64, False, 0),
        ("", "bfloat16", 1, 129, 8, 1, 128, False, 0),
        ("", "bfloat16", 2, 300, 8, 1, 32, True, 0),
        ("", "bfloat16", 1, 65, 4, 4, 32, True, 16),
        ("", "bfloat16", 1, 257, 8, 8, 128, True, 0),
        # deepseek-7b's prefill in [serverless]: MHA (G 1), hd 128, B 1
        ("deepseek-7b", "bfloat16", 1, SERVERLESS_PROMPT, 32, 32, 128, True, 0),
    ]
    for label, dt, B, S, H, K, hd, causal, window in flash_cases:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=gen).to(dev, dtype)
        k = torch.randn((B, S, K, hd), generator=gen).to(dev, dtype)
        v = torch.randn((B, S, K, hd), generator=gen).to(dev, dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        desc = f"{dt} B{B} S{S} H{H} K{K} hd{hd} causal={causal} window={window}"
        err = _check("flash_attention", out, ref, dt, desc)
        if not label:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = _timing_row(
            "flash_attention", f"{label} {desc}", dt,
            lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: flash_attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            "sdpa", 2 * (B * S * H * hd + B * S * K * hd) * q.element_size(),
            4 * B * H * hd * (S * (S + 1) // 2),  # causal: visible pairs only
            err)
        del ref
        if label in ("main", "deepseek-7b"):
            rows[("flash_attention", label)] = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:102",
                "shape": SHAPE_NOTES[label], **row}
    return rows


SHAPE_NOTES = {"main": "llama3.2-1b, main path (launches: main path)",
               "deepseek-7b": "deepseek-7b, [serverless] (launches: its requests there)"}


def _bound(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 3
PROMPT_LENS = (512, 384, 200, 64)
DECODE_STEPS = 32
FUSED_STEPS = 8
COMPARE_STEPS = 8


def main_path(cfg=None, device="cuda") -> dict:
    """The port's serving path end to end; `cfg` and `device` exist so the
    same code can be rehearsed at a small size on the CPU."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine

    cfg = cfg or get_config("llama3.2-1b")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    B, S = len(PROMPT_LENS), max(PROMPT_LENS)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(7),
                                        ShapeConfig("chip_smoke", S, B, "prefill"),
                                        device=dev)
    L = cfg.num_layers

    ops.reset_launch_counts()
    eng = Engine(8 << 30, device=dev)
    eng.register_model(cfg.name, cfg)
    model_bytes = sum(r.nbytes for r in eng.records_of(cfg.name))
    t0 = time.perf_counter()
    eng.load(cfg.name)
    cold_s = time.perf_counter() - t0
    cold = eng.last_load
    log(f"[main] model bytes {model_bytes}; cold load {cold_s:.3f} s: "
        + json.dumps({k: v for k, v in cold.as_dict().items() if v}))
    assert cold.bytes_h2d == model_bytes, (cold.bytes_h2d, model_bytes)
    assert cold.chunks_h2d > cold.tensors_h2d > 0
    eng.release(cfg.name)
    t0 = time.perf_counter()
    eng.load(cfg.name)
    warm_s = time.perf_counter() - t0
    warm = eng.last_load
    log(f"[main] warm load {warm_s * 1e3:.3f} ms: "
        + json.dumps({k: v for k, v in warm.as_dict().items() if v}))
    assert warm.tensors_h2d == 0 and warm.bytes_device_hit == model_bytes
    # device copies dropped, host copies kept: every tensor is a host hit
    # and crosses h2d again (the serverless warm-host start)
    eng.drop_device_copies(cfg.name)
    t0 = time.perf_counter()
    eng.load(cfg.name)
    host_s = time.perf_counter() - t0
    host = eng.last_load
    log(f"[main] host-tier load {host_s * 1e3:.3f} ms "
        f"({host.bytes_h2d / host.transfer_seconds / 1e9:.2f} GB/s h2d): "
        + json.dumps({k: v for k, v in host.as_dict().items() if v}))
    assert host.bytes_host_hit == host.bytes_h2d == model_bytes
    assert host.leaves_materialized == 0

    inst = eng.start_instance(cfg.name, max_blocks_per_seq=64, num_pages=256)
    sync()
    t0 = time.perf_counter()
    logits = inst.prefill(batch, lengths=PROMPT_LENS)
    sync()
    prefill_s = time.perf_counter() - t0
    assert logits.shape == (B, cfg.padded_vocab)
    tok = logits.argmax(-1).to(torch.int32)
    tokens = [tok]
    step_logits = []
    out = inst.decode(tok)  # warm-up step
    step_logits.append(out)
    tok = out.argmax(-1).to(torch.int32)
    tokens.append(tok)
    sync()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            out = inst.decode(tok)
            step_logits.append(out)
            tok = out.argmax(-1).to(torch.int32)
            tokens.append(tok)
        sync()  # outside the per-step path; ends the timed window
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    decode_s = time.perf_counter() - t0
    decode_dispatches = 1 + DECODE_STEPS

    inst2 = eng.start_instance(cfg.name, max_blocks_per_seq=64, num_pages=256)
    sync()
    t0 = time.perf_counter()
    tok2 = inst2.prefill(batch, lengths=PROMPT_LENS[::-1]).argmax(-1).to(torch.int32)
    sync()
    prefill2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(FUSED_STEPS):
        o1, o2 = eng.decode_many([(inst, tok), (inst2, tok2)])
        tok, tok2 = o1.argmax(-1).to(torch.int32), o2.argmax(-1).to(torch.int32)
    sync()
    fused_s = time.perf_counter() - t0
    assert bool(torch.isfinite(o1.float()).all()) and bool(torch.isfinite(o2.float()).all())
    inst.finish()
    inst2.finish()
    counts = ops.launch_counts()
    decode_dispatches += FUSED_STEPS
    prefills = 2
    log(f"[main] launches {json.dumps(counts)}; decode dispatches {decode_dispatches}, "
        f"prefills {prefills}, layers {L}")
    if cuda:  # CPU tensors run the plain versions and launch nothing
        assert counts["paged_attention"] == L * decode_dispatches, counts
        assert counts["flash_attention"] == L * prefills, counts

    for i, lg in enumerate(step_logits):
        assert lg.shape == (B, cfg.padded_vocab)
        assert bool(torch.isfinite(lg.float()).all()), f"non-finite logits at step {i}"
    log(f"[main] prefill {prefill_s * 1e3:.2f} ms first, {prefill2_s * 1e3:.2f} ms second, "
        f"for {sum(PROMPT_LENS)} prompt tokens (B={B}, padded S={S}); decode {decode_s / DECODE_STEPS * 1e3:.3f} ms/step, "
        f"{B * DECODE_STEPS / decode_s:.1f} tokens/s (B={B}, sync-free); "
        f"fused decode_many {fused_s / FUSED_STEPS * 1e3:.3f} ms/step (B={2 * B})")

    # the same prompts and fed tokens through the plain paged attention
    ref = eng.start_instance(cfg.name, max_blocks_per_seq=64, num_pages=256,
                             attn_mode="ref")
    ref_logits = ref.prefill(batch, lengths=PROMPT_LENS)
    flips = 0
    worst = 0.0
    for i in range(COMPARE_STEPS):
        ref_logits = ref.decode(tokens[i])
        ker = step_logits[i].float()
        rl = ref_logits.float()
        err = float((ker - rl).abs().max())
        scale = max(1.0, float(rl.abs().max()))
        worst = max(worst, err / scale)
        assert err <= TOL["bfloat16"] * scale, f"step {i}: logits differ by {err}"
        kt, rt = ker.argmax(-1), rl.argmax(-1)
        for b in torch.nonzero(kt != rt).flatten().tolist():
            # a different greedy token is allowed only at a tie within tolerance
            gap = float(rl[b, rt[b]] - rl[b, kt[b]])
            assert gap <= TOL["bfloat16"] * scale, f"step {i} seq {b}: gap {gap}"
            flips += 1
    ref.finish()
    log(f"[main] kernel vs plain paged attention over {COMPARE_STEPS} steps: max "
        f"relative logit error {worst:.3e} (tol {TOL['bfloat16']:g}), greedy tokens "
        f"equal except {flips} ties within tolerance")
    if cuda:
        profile_decode(eng, cfg, batch)
    eng.close()
    return counts


def _device_ms(prof, reps: int) -> tuple[dict[str, float], int]:
    """Device time per repetition of each kernel a profile saw, by name, and
    the number of kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return by_name, len(kernels)


def profile_decode(eng, cfg, batch, steps: int = 8):
    """Where the time goes: torch.profiler over a warm prefill and `steps`
    decode steps of a fresh instance (outside the counted main path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    inst = eng.start_instance(cfg.name, max_blocks_per_seq=64, num_pages=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok = inst.prefill(batch, lengths=PROMPT_LENS).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    by_name, _ = _device_ms(prof, 1)
    if by_name:
        busy_ms = sum(by_name.values())
        k2_ms = sum(t for n, t in by_name.items() if "flash_bf16_kernel" in n)
        log(f"[profile] prefill B={len(PROMPT_LENS)} S={max(PROMPT_LENS)} (profiled): wall "
            f"{prefill_ms:.3f} ms, device busy {busy_ms:.3f} ms, K2 {k2_ms:.3f} ms")
    tok = inst.decode(tok).argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = inst.decode(tok).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    inst.finish()
    by_name, n_kernels = _device_ms(prof, steps)
    if not by_name:
        log("[profile] decode: device time not measured (the profiler saw no CUDA events)")
        return
    busy_ms = sum(by_name.values())
    k1_ms = sum(t for n, t in by_name.items()
                if "paged_split_kernel" in n or "paged_combine_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] decode B={len(PROMPT_LENS)} (profiled): wall {wall_ms:.3f} ms/step, "
        f"device busy {busy_ms:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{n_kernels / steps:.0f} kernels/step, K1 (split + combine) {k1_ms:.3f} ms/step; top: "
        + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))

# ------------------------------------------------------------------ phase 4
SERVERLESS_MODELS = ("llama3.2-1b", "deepseek-7b")
# the launcher's default trace (seed 0, 20 s mean gap) at 10 requests: with a
# fixed 10 s keep-alive, no arrival finds the other model warm (the pool
# cannot hold both retained) and the run has warm starts, full h2d cold
# starts and partial-reuse cold starts
SERVERLESS_TRACE = dict(n_requests=10, seed=0, mean_interarrival=20.0)
SERVERLESS_KEEP_ALIVE = "fixed:10"
SERVERLESS_PROMPT, SERVERLESS_GEN = 256, 16
FLEET_TRACE = dict(n_requests=10, seed=3, mean_interarrival=20.0)
FLEET_CHAOS_SEED = 1  # the seeded pick crashes engine0
FLEET_HOST_CACHE = 1 << 30  # per engine: released tensors spill past 1 GiB
CHUNK_BYTES = 16 << 20  # the engines' h2d chunk (Engine's default)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def draw_weights(cfg, seed: int, device="cuda"):
    """A model's random weights, drawn once from a seeded generator on
    `device` and kept in host memory (page-locked on CUDA, so every engine's
    host tier holds these very buffers and its h2d runs asynchronously)."""
    import torch

    from repro_torch.models import build_model

    dev = torch.device(device)
    tree = build_model(cfg).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    if dev.type == "cpu":
        return tree
    host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t),
                    tree)
    del tree
    torch.cuda.empty_cache()
    return host


def host_memory() -> str:
    """This process's resident host memory and the machine's available
    memory (Linux), for the phase lines."""
    try:
        rss = next(line.split()[1] for line in open("/proc/self/status")
                   if line.startswith("VmRSS"))
        avail = next(line.split()[1] for line in open("/proc/meminfo")
                     if line.startswith("MemAvailable"))
        return f"host RSS {int(rss) / 2**20:.1f} GiB, available {int(avail) / 2**20:.1f} GiB"
    except (OSError, StopIteration):
        return "host memory not measured"


def allocated(dev) -> int:
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(dev)


def device_bytes(eng) -> int:
    """Bytes of every device tensor the engine holds: its pool's buffers, KV
    slabs, fused tables and live instances' tables."""
    import torch

    tensors = list(eng._tensors.values())
    for slab in eng._slabs.values():
        tensors += [slab.k_pages, slab.v_pages]
    for cached in eng._fused.values():
        tensors += [t for t in cached if isinstance(t, torch.Tensor)]
    for insts in eng._live_instances.values():
        for inst in insts:
            tensors += [t for t in (inst._tables, inst._lengths) if t is not None]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if t.device.type == "cuda"}
    return sum(storages.values())


def recording_engine():
    """`Engine` that ledgers every load, counts each model's kernel launches
    (the launch counters read when an instance starts and when it finishes),
    and keeps, for the first instance of each model, the prompt batch, the
    fed token and clones of the first prefill and decode logits (device
    copies: no host read).  The hooks hold their instance weakly, so a
    finished instance is freed at once."""
    import weakref

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    class RecordingEngine(Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.loads, self.first = [], {}
            self.launches, self._launches_at = {}, {}

        def load(self, model_id, **kw):
            rep = super().load(model_id, **kw)
            self.loads.append((model_id, rep, self.last_load))
            return rep

        def finish_instance(self, model_id):
            super().finish_instance(model_id)
            at = self._launches_at.pop(model_id, None)
            if at is None:  # an instance the crash already dropped
                return
            mine = self.launches.setdefault(model_id, dict.fromkeys(at, 0))
            for k, n in ops.launch_counts().items():
                mine[k] += n - at[k]

        def start_instance(self, model_id, **kw):
            self._launches_at[model_id] = ops.launch_counts()
            inst = super().start_instance(model_id, **kw)
            if model_id in self.first:
                return inst
            rec = self.first[model_id] = {}
            ref = weakref.ref(inst)

            def first_prefill(batch, **k):
                out = type(ref()).prefill(ref(), batch, **k)
                rec.update(batch=batch, prefill=out.detach().clone())
                return out

            def first_decode(tok):
                out = type(ref()).decode(ref(), tok)
                if "decode" not in rec:
                    rec.update(token=tok.clone(), decode=out.detach().clone())
                return out

            inst.prefill, inst.decode = first_prefill, first_decode
            return inst

    return RecordingEngine


def hold_first_tokens(eng, names):
    """The first request of each model through the plain attention (flash
    and paged) on the same engine, weights, prompt and fed token: its first
    prefill and decode logits within the bf16 tolerance relative to scale."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    worst = {}
    for m in names:
        rec = eng.first[m]
        eng.load(m)
        inst = eng.start_instance(m, attn_mode="ref")
        kernel = ops.flash_attention
        ops.flash_attention = flash_attention_ref  # the plain prefill path
        try:
            plain = {"prefill": inst.prefill(rec["batch"])}
        finally:
            ops.flash_attention = kernel
        plain["decode"] = inst.decode(rec["token"])
        inst.finish()
        eng.release(m)
        for step, want in plain.items():
            got, want = rec[step].float(), want.float()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[(m, step)] = err / scale
            assert err <= TOL["bfloat16"] * scale, f"{m} {step}: logits differ by {err}"
    log("[serverless] first request of each model vs the plain attention path: "
        + ", ".join(f"{m} {step} {e:.3e}" for (m, step), e in worst.items())
        + f" (max |diff| / scale, tol {TOL['bfloat16']:g})")


def _load_line(i, rec, load, size) -> str:
    m, rep, st = load
    return (f"req {i}: {m:12s} {'cold' if rec.cold else 'warm'} "
            f"reuse {rep.reuse_fraction:.4f}; bytes device-hit {st.bytes_device_hit} "
            f"h2d {st.bytes_h2d} (host {st.bytes_host_hit}, store {st.bytes_store}, "
            f"prefetched {st.bytes_prefetched}, materialized leaves "
            f"{st.leaves_materialized}) of {size}; init {rec.init_s * 1e3:.3f} ms, "
            f"load {rec.load_s * 1e3:.3f} ms (h2d {st.transfer_seconds * 1e3:.3f} ms), "
            f"profile {rec.profile_s * 1e3:.3f} ms, prefill {rec.prefill_s * 1e3:.3f} ms, "
            f"decode {rec.decode_s / max(SERVERLESS_GEN, 1) * 1e3:.3f} ms/token, "
            f"TTFT {rec.ttft * 1e3:.3f} ms")


def check_loads(loads, sizes):
    """Every load moves exactly the bytes its report transfers, and the
    device hits plus the h2d bytes are the whole model."""
    for m, rep, st in loads:
        assert st.bytes_device_hit + st.bytes_h2d == sizes[m], (m, st.as_dict())
        assert st.bytes_h2d == rep.bytes_transferred, (m, st.bytes_h2d, rep.bytes_transferred)


def model_sizes(cfgs: dict) -> dict:
    from repro_torch.models.tensors import spec_records

    return {m: sum(r.nbytes for r in spec_records(m, cfg)) for m, cfg in cfgs.items()}


def serverless_phase(cfgs: dict, weights: dict, device="cuda") -> dict:
    """The single-engine `Gateway` over `cfgs`; returns the launch counts of
    each model's requests, as the counters measured them."""
    import torch

    from repro_torch.core.trace import SimModel
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _print_ttft_breakdown
    from repro_torch.serverless import Gateway, poisson_trace

    dev = torch.device(device)
    names = list(cfgs)
    sizes = model_sizes(cfgs)
    pool = max(sizes.values()) + min(sizes.values()) // 2  # never both models
    eng = recording_engine()(pool, device=dev, engine_id="serverless")
    for m in names:
        eng.register(m, cfgs[m], init_fn=lambda w=weights[m]: w)
    gc.collect()  # what earlier phases left in reference cycles
    base = allocated(dev)
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in names], **SERVERLESS_TRACE)
    gw = Gateway(eng, keep_alive=SERVERLESS_KEEP_ALIVE, prompt_len=SERVERLESS_PROMPT,
                 gen_tokens=SERVERLESS_GEN)
    log(f"[serverless] pool {pool} B; models {sizes}; trace {SERVERLESS_TRACE}, keep-alive "
        f"{SERVERLESS_KEEP_ALIVE}, prompt {SERVERLESS_PROMPT}, {SERVERLESS_GEN} tokens")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sink = gw.run_trace(trace)
    replay_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_model = {m: dict(c) for m, c in eng.launches.items()}
    recs = sink.records
    assert len(recs) == len(eng.loads) == len(trace)
    for i, (rec, load) in enumerate(zip(recs, eng.loads)):
        log("[serverless] " + _load_line(i, rec, load, sizes[load[0]]))
    check_loads(eng.loads, sizes)
    kinds = {"warm": [i for i, r in enumerate(recs) if not r.cold],
             "full h2d cold": [i for i, (r, (m, _, st)) in enumerate(zip(recs, eng.loads))
                               if r.cold and st.bytes_h2d == sizes[m]],
             "partial-reuse cold": [i for i, (r, (_, rep, _)) in enumerate(zip(recs, eng.loads))
                                    if r.cold and 0 < rep.reuse_fraction < 1]}
    log(f"[serverless] starts: {kinds}; replay {replay_s:.3f} s")
    assert all(kinds.values()), kinds
    # every layer runs K2 once per prefill and K1 once per decode step
    expected = {m: {"paged_attention": cfgs[m].num_layers * SERVERLESS_GEN * n,
                    "flash_attention": cfgs[m].num_layers * n}
                for m in names for n in [sum(r.model_id == m for r in recs)]}
    log(f"[serverless] launches {json.dumps(counts)}; by model {json.dumps(per_model)} "
        f"(expected {json.dumps(expected)})")
    if dev.type == "cuda":
        assert per_model == expected, (per_model, expected)
        for k in counts:
            assert counts[k] == sum(c[k] for c in per_model.values()), (counts, per_model)
    log(f"[serverless] summary {json.dumps(sink.summary())}")
    _print_ttft_breakdown(recs)
    hold_first_tokens(eng, names)
    eng.crash()
    after = allocated(dev)
    log(f"[serverless] crash: device memory {after} B allocated, {base} B before the first "
        f"load (one chunk = {CHUNK_BYTES} B)")
    assert after - base <= CHUNK_BYTES, (base, after)
    eng.close()
    return per_model


# ------------------------------------------------------------------ phase 5
def fleet_phase(cfgs: dict, weights: dict, device="cuda") -> dict:
    """`FleetGateway` over two engines under the seeded chaos schedule, then
    a `Gateway` replay on the recovered engine."""
    import torch

    from repro_torch.core.faults import FaultInjector
    from repro_torch.core.trace import Request, SimModel
    from repro_torch.serverless import FleetGateway, Gateway, chaos_schedule, poisson_trace

    dev = torch.device(device)
    names = list(cfgs)
    sizes = model_sizes(cfgs)
    pool = max(sizes.values()) + min(sizes.values()) // 2
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in names], **FLEET_TRACE)
    # the crash lands after the fourth arrival; the engine rejoins before
    # the seventh
    crash_t = trace[3].time + 1.0
    specs, events = chaos_schedule(seed=FLEET_CHAOS_SEED, n_engines=2, crash_time=crash_t,
                                   recover_after=trace[6].time - 1.0 - crash_t)
    Engine = recording_engine()
    engines = []
    for i in range(2):
        eng = Engine(pool, device=dev, engine_id=f"engine{i}",
                     host_cache_bytes=FLEET_HOST_CACHE,
                     faults=FaultInjector(specs=tuple(specs[i]), seed=FLEET_CHAOS_SEED))
        for m in names:
            eng.register(m, cfgs[m], init_fn=lambda w=weights[m]: w)
        engines.append(eng)
    checks = []

    class Fleet(FleetGateway):
        def _apply_fault(self, now, kind, engine_id):
            eng = next(n.engine for n in self.nodes if n.device_id == engine_id)
            before, held = allocated(dev), device_bytes(eng)
            super()._apply_fault(now, kind, engine_id)
            if kind == "crash":
                checks.append((engine_id, before, held, allocated(dev)))

    gc.collect()
    base = allocated(dev)
    fg = Fleet(engines, keep_alive=SERVERLESS_KEEP_ALIVE, prompt_len=SERVERLESS_PROMPT,
               gen_tokens=SERVERLESS_GEN)
    log(f"[fleet] 2 engines, pool {pool} B each, host tier {FLEET_HOST_CACHE} B each; models "
        f"{sizes}; trace {FLEET_TRACE}; chaos seed {FLEET_CHAOS_SEED}: "
        + "; ".join(f"{e.engine_id} crash at {e.time:.3f} s, back after "
                    f"{e.recover_after:.3f} s" for e in events))
    t0 = time.perf_counter()
    sink = fg.run_trace(trace, faults=events)
    replay_s = time.perf_counter() - t0
    for d, rec in zip(fg.decisions, sink.records):
        log(f"[fleet] t {d[0]:.3f} {d[1]:12s} -> {d[2]} {'cold' if d[3] else 'warm'} queue "
            f"{d[4]:.6f} s; load {rec.load_s * 1e3:.3f} ms, prefill {rec.prefill_s * 1e3:.3f} "
            f"ms, store bytes {rec.bytes_from_store}, prefetched {rec.prefetched}")
    for eng in engines:
        check_loads(eng.loads, sizes)
        log(f"[fleet] {eng.engine_id} fault ledger {json.dumps(eng.fault_summary())}")
    summary = fg.summary()
    log(f"[fleet] dropped {summary['dropped_requests']}, redriven "
        f"{summary['requests_redriven']}, interrupted {summary['requests_interrupted']}, "
        f"crashes {summary['engine_crashes']}, recoveries {summary['engine_recoveries']}; "
        f"replay {replay_s:.3f} s")
    assert summary["dropped_requests"] == 0
    assert summary["engine_crashes"] == 1 == summary["engine_recoveries"]
    assert sum(e.fault_summary()["h2d_stalls"] for e in engines) >= 1
    (crashed, before, held, after), = checks
    log(f"[fleet] crash of {crashed}: device memory {before} -> {after} B allocated, "
        f"the engine held {held} B (one chunk = {CHUNK_BYTES} B)")
    assert abs(before - held - after) <= CHUNK_BYTES, (before, held, after)
    log("[fleet] placement hints / joined loads per engine: "
        + ", ".join(f"{e.engine_id} {e.prefetcher.hints} / {e.prefetcher.joins}"
                    for e in engines))

    # the recovered engine serves again: the Gateway's next-model hint has
    # the current request's service as its window, so the prefetch worker
    # promotes spilled tensors before the hinted load joins
    eng = next(e for e in engines if e.engine_id == crashed)
    n0 = len(eng.loads)
    big = max(names, key=sizes.get)
    small = min(names, key=sizes.get)
    t_end = max(trace[-1].time, max(d[0] for d in fg.decisions)) + 100.0
    replay = [Request(t_end + 100.0 * i, m, "gsm8k", SERVERLESS_PROMPT, SERVERLESS_GEN, 1)
              for i, m in enumerate([big, small, big, small])]
    gw = Gateway(eng, keep_alive="zero", prompt_len=SERVERLESS_PROMPT,
                 gen_tokens=SERVERLESS_GEN)
    gw_sink = gw.run_trace(replay)
    for i, (rec, load) in enumerate(zip(gw_sink.records, eng.loads[n0:])):
        log(f"[fleet] {crashed} (recovered) " + _load_line(i, rec, load, sizes[load[0]]))
    check_loads(eng.loads, sizes)
    loads = [ld for e in engines for ld in e.loads]
    store = [ld for ld in loads if ld[2].bytes_store > 0]
    prefetched = [ld for ld in loads if ld[2].bytes_prefetched > 0]
    log(f"[fleet] loads with store-tier bytes: {len(store)}, with prefetched bytes: "
        f"{len(prefetched)}; {crashed} fault ledger {json.dumps(eng.fault_summary())}; "
        f"{host_memory()}")
    assert store and prefetched
    for e in engines:
        e.close()
    del engines, fg, gw, eng, e
    gc.collect()
    log(f"[fleet] device memory after closing the fleet: {allocated(dev)} B ({base} B before)")
    return summary


# ------------------------------------------------------------------ phase 6
def launcher_phase(device="cuda"):
    """The serving launcher as users run it, in a subprocess, at its own
    smoke sizes."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--trace", "poisson",
           "--n-engines", "2", "--chaos", "--device", device]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        log(f"[launcher] {line}")
    if out.returncode != 0:
        raise RuntimeError(f"launcher exited {out.returncode}:\n{out.stderr[-3000:]}")
    assert "serverless summary:" in out.stdout and "chaos fleet:" in out.stdout
    log(f"[launcher] exit 0 in {time.perf_counter() - t0:.3f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = setup()
    t0 = time.perf_counter()
    rows = check_kernels()
    log(f"[phase] kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = main_path()
    log(f"[phase] main path {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfgs = {m: get_config(m) for m in SERVERLESS_MODELS}
    weights = {m: draw_weights(cfg, seed) for seed, (m, cfg) in enumerate(cfgs.items())}
    log(f"[phase] weights drawn {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    per_model = serverless_phase(cfgs, weights)
    log(f"[phase] serverless {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    fleet_phase(cfgs, weights)
    log(f"[phase] fleet {time.perf_counter() - t0:.1f} s; {host_memory()}")
    del weights
    gc.collect()
    t0 = time.perf_counter()
    launcher_phase()
    log(f"[phase] launcher {time.perf_counter() - t0:.1f} s")
    for (name, label), row in rows.items():
        row["launches"] = counts[name] if label == "main" else per_model["deepseek-7b"][name]
    kernels = [{k: rows[key][k] for k in ("name", "route", "source", "replaces", "shape",
                                          "launches", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}
               for key in (("paged_attention", "main"), ("flash_attention", "main"),
                           ("paged_attention", "deepseek-7b"),
                           ("flash_attention", "deepseek-7b"))]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
