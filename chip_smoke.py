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
   splits a warm prefill and 8 decode steps by kernel (`[profile]` lines).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
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
    the main-path and long-context shapes.  Returns the main-path rows."""
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
        if label == "main":
            # no single PyTorch call does paged attention: the gathered SDPA
            # above is printed, not reported as the library time
            rows["paged_attention"] = {
                "name": "paged_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:120",
                **row, "library_ms": None}

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
        if label == "main":
            rows["flash_attention"] = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:102", **row}
    return rows


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
    rows = check_kernels()
    counts = main_path()
    for name, row in rows.items():
        row["launches"] = counts[name]
    kernels = [{k: rows[n][k] for k in ("name", "route", "source", "replaces", "launches",
                                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
               for n in ("paged_attention", "flash_attention")]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
