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
   bf16; paged decode: lengths 0 and 1, at and +-1 around the split
   boundaries, full tables, a long context, G of 1 to 16 (7 included),
   head dim 64 / 128; prefill: S of 1 to 512 around the 64-row tiles,
   sliding windows, non-causal, head dim 32 / 64 / 128 / 256, G of 1 / 4 /
   7 / 8 / 16; the routed experts: routed and dropped pairs at qwen3-moe's,
   mixtral's and smoke widths; the decode step's rope + K/V write, to the
   bit, at every served model's decode shape, M-RoPE included, and across a
   page boundary), with the kernel's, the plain version's and a PyTorch
   call's time (for the routed experts, the slot path's expert products;
   none for the rope + K/V write) beside the bound, at the shapes of every
   model the script serves and at one long shape each (`[timing]` lines: a 4000-token
   conversation at batch 1, a 4096-token prompt);
3. main path at full width on llama3.2-1b (random weights from a seed):
   `Engine.register_model`, a cold then a warm `Engine.load`, prefill of 4
   prompts of lengths 512/384/200/64, 1 + 32 decode steps under
   `torch.cuda.set_sync_debug_mode("error")`, a second instance and 8 fused
   `decode_many` steps, the decode step a CUDA graph from its second call
   on (the engine's default, `serving/step_graph.py`).  Launch counters are
   zeroed just before and read just after; the decode logits are then held
   against the same run with the plain paged attention (`attn_mode="ref"`),
   and `torch.profiler` splits a warm prefill and 8 decode steps by kernel
   (`[profile]` lines);
4. `[serverless]`: the single-engine `Gateway` at full width over
   llama3.2-1b and deepseek-7b (weights drawn once each, on the card from a
   seeded generator, kept in page-locked host memory and handed to every
   engine as its `init_fn`), one pool that holds deepseek-7b and its KV but
   not both models, a seeded Poisson trace of 10 requests (prompt 256,
   16 greedy tokens) under a fixed 10 s keep-alive: warm starts, full h2d
   cold starts and cold starts that reuse part of the model from the pool.
   Every load's bytes are checked against the model's, the first request of
   each model is held against the plain attention path (a MoE model's on
   the eager step, so its router replay sees every step), launch counts
   against the requests, each model's graphed decode at B 1 after its
   capture against its weight-read floor, and a crash must give the card's
   memory back.  A model's compiled decode steps outlive its requests while
   its params tree stays assembled: each request's line gives the eager
   steps, captures and replays its decode made, every request whose model's
   tree and slab are unchanged since its previous request must make 0
   eager steps and 0 captures, and each model's first such request is run
   again on the eager step over the same prompt and tokens (bitwise, else
   within the bf16 tolerance); the gateway phases below do the same;
5. `[fleet]`: `FleetGateway` over two engines on the card under the seeded
   `chaos_schedule` (an h2d stall and a prefetch-worker death per engine, a
   crash and a recovery), host tiers bounded so that released tensors
   spill to the persistent store; then the recovered engine serves a
   `Gateway` replay whose next-model hints promote spilled tensors while
   the current request runs;
6. `[trace]`: an `Engine` with a `Tracer` at llama3.2-1b's full width and a
   host tier that holds nothing: a cold load, a store-tier reload, a
   prefill and 3 fused decode steps; the span families, each phase nested
   in its load, and the Chrome trace (build/trace/) loaded back;
6b. `[graphs]`: llama3.2-1b at full width on an eager engine
   (``cuda_graphs=False``) and a graphed one over the same weights: 32 B 4
   decode steps (the capture inside the sync-error window; the device
   copies dropped and reloaded before step 16, the graph with them, then
   recaptured) and 32 fused B 8 steps, the graphed run fed the eager run's
   tokens: logits equal (bitwise, else within the bf16 tolerance), launches
   equal, device memory after `finish` the eager engine's plus the two keys
   that outlive the instances (within the budget), and the eager engine's
   after `close`; capture time, pool bytes, host time of a step, steady
   walls, and `[profile]` of both;
7. `[dedup]`: deepseek-7b and three fine-tune variants registered with
   `Engine.register_variant` (delta leaves: the layer-stacked wq and wo).
   With the base resident, each variant's cold load moves exactly its delta
   over h2d and its shared leaves are the base's device storage; its first
   logits hold against the plain attention and differ from the base's.
   Then a pool of the base, one delta and one request's KV serves them
   again, evicting deltas but no leaf a model in use reads;
8. `[migration]`: a deepseek-7b decode handed from one `Engine` to another
   on the card (`migrate_out` after 8 tokens, `migrate_in` replaying the 4
   the source decoded after the snapshot) must give the source's logits
   bit for bit;
9. `[families]`: the `Gateway` as in `[serverless]`, over qwen3-moe-30b-a3b
   (MoE, full width, 12 of its 48 layers) and qwen2-vl-7b (M-RoPE and
   vision patches, full width and depth), 512-token prompts, a seeded
   Poisson trace of 8 requests;
10. `[dense]`: the `Gateway` as in `[serverless]` over yi-9b (GQA, G 8) and
   codeqwen1.5-7b (MHA, G 1) at full width and depth, one pool that holds
   either but not both: warm, full h2d and partial-reuse cold starts, K1
   and K2 in every layer, first logits against the plain attention path;
11. `[state-families]`: the `Gateway` over the families the Engine serves
   through its non-paged fallback, at full width: mamba2-2.7b (SSD),
   recurrentgemma-9b (RG-LRU + local MQA at head dim 256), whisper-tiny
   (encoder-decoder, 1500 encoder frames) and mixtral-8x7b (MoE + SWA
   ring; 6 of its 32 layers), 512-token prompts, a seeded Poisson trace of
   10 requests, the decode step a CUDA graph from a key's second call on
   (the engine's default since PR 20), each model's graphed decode at B 1
   after its capture against its weight-read floor and profiled; then one
   prompt longer than the window per SWA model (recurrentgemma-9b 2200,
   mixtral 4200) straight through `Engine`, over a window-sized ring, held
   against the plain attention path on the eager step (the MoE router
   replay sees every step) and the graphed run against the eager one; then
   each model on an eager engine (``cuda_graphs=False``) and a graphed one
   over the same weights, prompt 512 and 16 decode steps, the graphed run
   fed the eager run's tokens: logits equal (bitwise, else within the bf16
   tolerance), requested device bytes after `finish` the eager engine's
   plus the live key's tensors and equal after `close`, steady walls,
   `[profile]` of both, each graph's capture time, private pool and the
   bytes a replay copies; and mamba2-2.7b's replays on the gateway engine
   profiled with its prefetch worker idle and then promoting spilled
   leaves (`prefetch_probe`);
12. `[launcher]`: ``python -m repro_torch.launch.serve --trace poisson
   --n-engines 2 --chaos`` at the launcher's own smoke sizes, on the card;
13. `[examples]`: the four ported examples (``python -m
   repro_torch.examples.<name>``: quickstart, serve_engine, serve_cluster,
   train_100m) at the reference's sizes, started together on the card, each
   exiting 0 with its own check;
14. `[train]`: the training path, which launches neither kernel (the loss
   runs the plain attention, as the reference's does; both counters must
   stay 0).  llama3.2-1b at full width and depth through
   `repro_torch.launch.train.main` (B 8, S 512, bf16, remat off, 12 steps:
   step wall, tokens/s, model FLOP/s, peak memory), then (a) the first loss
   near ln(vocab), (b) one step's bf16 loss and gradients against the same
   step in fp32, (c) the loss over 20 steps on one repeated batch falls by
   more than 1 nat, (d) remat on against off (loss, gradients, peak
   memory) and the launcher's steps again with remat on, and a profile of 3
   steps; a checkpoint round trip of the trained params and AdamW moments
   at full width (bitwise); qwen3-moe-30b-a3b at full width, 4 of its 48
   layers, through the launcher's loop under each MoE dispatch, and the
   three dispatches' losses and gradients held against each other; the
   training launcher's CLI contract (a module run, a resume, every
   architecture at --smoke).

15. `[distributed]`: the distributed path (`repro_torch.distributed`) on a
   1x1 mesh of a one-rank NCCL group, llama3.2-1b at full width and depth:
   `make_train_step` (B 8, S 512, bf16, remat on; its gradients against
   `launch.train`'s, then 3 steps of each), `make_prefill_step` (B 4, S 512;
   K2 through `local_map`, its launches counted; last logits against
   `Model.prefill` and the plain attention), `make_serve_step` (8 tokens
   over the prefill's 512-slot caches, sequence-sharded: the flash-decode
   combine; against `Model.decode`), each step's wall beside the
   undistributed path's; an elastic checkpoint round trip (DTensor leaves
   saved whole, restored onto the prefill step's placements); `compressed_grad_fn`
   (int8 all-gather) against the exact gradient; and the dry-run
   (``python -m repro_torch.launch.dryrun``, llama3.2-1b's three shapes on
   the 16x16 mesh and train_4k on 2x16x16) in processes of its own.

Each phase frees the page-locked weights it drew before the next draws its
own, and every phase line prints the host's memory.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
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
                nbytes: int, flops: int, err: float, note: str = "") -> dict:
    """Kernel, plain-version and library times of one shape beside its bound,
    achieved rate and share of the bound (and `note`); `library` None where
    no library call does the kernel's work."""
    ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    library_ms = None if library is None else cuda_time_ms(library)
    bound_ms, bound_by = _bound(nbytes, flops, dt)
    rate = (f"{nbytes / ms / 1e9:.3f} TB/s" if bound_by == "bytes"
            else f"{flops / ms / 1e9:.1f} TFLOP/s")
    lib = ("library none" if library is None else
           f"{lib_label} {library_ms:.4f} ms")
    vs = "" if library is None else f", {ms / library_ms:.2f}x the library call"
    log(f"[timing] {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{lib}, bound {bound_ms:.5f} ms ({bound_by}); "
        f"achieved {rate}, {bound_ms / ms:.3f} of the bound{vs}{note}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_kernels() -> dict:
    """Every kernel against its plain version over a sweep of shapes; times
    the main-path, long-context and each served model's shapes.  Returns the
    rows of the main path's and the served models' shapes, keyed (kernel,
    label)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import visible_pairs
    from repro_torch.kernels.paged_attention import row_groups, split_plan
    from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    rows = {}
    main_args = {}  # the main path's shapes, for `dispatch_cost`

    def plan(B, H, K, N, T):
        """The kernel's (split_tokens, splits) at these shapes on this card."""
        return split_plan(B, K * row_groups(H // K), N, T, sms)

    # K1: (label, dtype, B, H, K, hd, T, N, lengths), lengths either a tuple
    # or a function of the case's split_tokens.  Timed: the main path's
    # decode shape (llama3.2-1b, lengths after prefill + decode) and one long
    # conversation at batch 1.  The rest put lengths at split boundaries and
    # +-1 of them, a full table, length 0 and 1, G of 1 / 4 / 8 / 16.
    paged_cases = [
        ("main", "bfloat16", 4, 32, 8, 64, 16, 64, (545, 417, 233, 97)),
        ("long", "bfloat16", 1, 32, 8, 64, 16, 256, (4000,)),
        ("", "bfloat16", 4, 32, 8, 64, 16, 64, lambda st: (st - 1, st, st + 1, 1)),
        ("", "bfloat16", 4, 32, 8, 64, 16, 64,
         lambda st: (2 * st - 1, 2 * st, 2 * st + 1, 1024)),
        ("", "float32", 4, 32, 8, 64, 16, 64, (1, 17, 200, 1024)),
        ("", "float32", 4, 32, 8, 64, 16, 64, lambda st: (st - 1, st + 1, 0, 3 * st)),
        ("", "bfloat16", 4, 32, 4, 128, 16, 64, (1, 33, 513, 1000)),
        ("", "float32", 3, 32, 4, 128, 16, 32, (5, 16, 509)),
        ("", "bfloat16", 2, 16, 1, 128, 32, 4, (1, 100)),
        ("", "bfloat16", 2, 8, 8, 64, 16, 16, lambda st: (st, 256)),
        ("", "float32", 2, 8, 8, 128, 16, 16, lambda st: (st + 1, 255)),
        ("", "float32", 3, 32, 8, 64, 32, 8, lambda st: (st - 1, st, 256)),
        ("", "bfloat16", 1, 32, 8, 128, 16, 256, (4096,)),
        # deepseek-7b's decode in [serverless]: MHA (G 1), hd 128, B 1, the
        # last step of a 256-token prompt and 16 greedy tokens
        ("deepseek-7b", "bfloat16", 1, 32, 32, 128, 16, 64,
         (SERVERLESS_PROMPT + SERVERLESS_GEN,)),
        # qwen2-vl-7b's G 7 (H 28, K 4): lengths at and +-1 around the
        # split boundaries, and 1
        ("", "bfloat16", 4, 28, 4, 128, 16, 64, lambda st: (st - 1, st, st + 1, 1)),
        ("", "float32", 4, 28, 4, 128, 16, 64,
         lambda st: (2 * st - 1, 2 * st, 2 * st + 1, 1)),
        ("", "bfloat16", 3, 28, 4, 128, 16, 64, lambda st: (3 * st + 1, 1, 2 * st)),
        ("", "float32", 2, 28, 4, 128, 16, 64, lambda st: (st, 1)),
        # the last decode step of [families]: a 512-token prompt and 16 greedy
        # tokens, qwen3-moe-30b-a3b (G 8) and qwen2-vl-7b (G 7), hd 128, B 1
        ("qwen3-moe-30b-a3b", "bfloat16", 1, 32, 4, 128, 16, 64,
         (FAMILY_PROMPT + SERVERLESS_GEN,)),
        ("qwen2-vl-7b", "bfloat16", 1, 28, 4, 128, 16, 64,
         (FAMILY_PROMPT + SERVERLESS_GEN,)),
        # the last decode step of [dense]: yi-9b (G 8) and codeqwen1.5-7b
        # (G 1), hd 128, B 1, a 256-token prompt and 16 greedy tokens (last,
        # so the paged cases above draw the inputs they drew before)
        ("yi-9b", "bfloat16", 1, 32, 4, 128, 16, 64, (SERVERLESS_PROMPT + SERVERLESS_GEN,)),
        ("codeqwen1.5-7b", "bfloat16", 1, 32, 32, 128, 16, 64,
         (SERVERLESS_PROMPT + SERVERLESS_GEN,)),
    ]
    for label, dt, B, H, K, hd, T, N, lengths in paged_cases:
        dtype = getattr(torch, dt)
        st, splits = plan(B, H, K, N, T)
        if callable(lengths):
            lengths = lengths(st)
        args = _paged_inputs(gen, dtype, B, H, K, hd, T, N, lengths, dev)
        out = ops.paged_attention(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = _check("paged_attention", out, ref, dt,
                     f"{dt} B{B} H{H} K{K} hd{hd} T{T} N{N} lengths {list(lengths)}")
        if not label:
            continue
        if label == "main":
            main_args["paged_attention"] = args
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
        head_blocks = K * row_groups(H // K)
        live_blocks = sum(math.ceil(n / st) for n in lengths) * head_blocks
        row = _timing_row(
            "paged_attention", f"{label} {dt} B{B} H{H} K{K} hd{hd} T{T} N{N} "
            f"lengths {list(lengths)}", dt,
            lambda: ops.paged_attention(*args), lambda: paged_attention_ref(*args),
            lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=mask),
            "sdpa on pre-gathered dense K/V", nbytes, 4 * live * H * hd, err,
            f"; {live_blocks} live blocks of {splits * head_blocks * B} launched "
            f"(splits of {st} tokens)")
        if label != "long":
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
        # qwen2-vl-7b's G 7 (H 28, K 4), causal, around the 64-row tiles
        *[("", dt, 1, S, 28, 4, 128, True, 0)
          for dt in ("bfloat16", "float32") for S in (1, 63, 64, 65, 512)],
        # the prefills of [families]: B 1, S 512, hd 128
        ("qwen3-moe-30b-a3b", "bfloat16", 1, FAMILY_PROMPT, 32, 4, 128, True, 0),
        ("qwen2-vl-7b", "bfloat16", 1, FAMILY_PROMPT, 28, 4, 128, True, 0),
        # hd 256 (recurrentgemma-9b's local MQA): G 1 / 8 / 16, S around the
        # 64-row tiles, windows across several tiles, non-causal
        *[("", dt, 1, S, 16, 1, 256, True, 0)
          for dt in ("bfloat16", "float32") for S in (1, 63, 64, 65, 300)],
        ("", "bfloat16", 2, 129, 16, 16, 256, True, 0),
        ("", "bfloat16", 1, 300, 16, 2, 256, True, 100),
        ("", "bfloat16", 1, 330, 16, 1, 256, True, 64),
        ("", "float32", 1, 330, 16, 2, 256, True, 64),
        ("", "bfloat16", 1, 200, 16, 1, 256, False, 0),
        ("", "float32", 1, 200, 16, 16, 256, False, 80),
        # the prefills of [state-families] (B 1): recurrentgemma-9b's local
        # attention (MQA G 16, hd 256, window 2048) at the Gateway's 512 and
        # the long probe's 2200; mixtral (window 4096) at 512 and at 4200;
        # whisper-tiny's encoder (S 1500, non-causal)
        ("recurrentgemma-9b", "bfloat16", 1, STATE_PROMPT, 16, 1, 256, True, 2048),
        ("recurrentgemma-9b long", "bfloat16", 1, STATE_LONG["recurrentgemma-9b"],
         16, 1, 256, True, 2048),
        ("mixtral-8x7b", "bfloat16", 1, STATE_PROMPT, 32, 8, 128, True, 4096),
        ("mixtral-8x7b long", "bfloat16", 1, STATE_LONG["mixtral-8x7b"], 32, 8, 128,
         True, 4096),
        ("whisper-tiny", "bfloat16", 1, 1500, 6, 6, 64, False, 0),
        # [distributed]'s prefill step: llama3.2-1b's prefill shape, each
        # rank's heads through local_map (all 32 on the one-rank mesh)
        ("distributed", "bfloat16", DIST_PREFILL[0], DIST_PREFILL[1], 32, 8, 64, True, 0),
        # the prefills of [dense]: B 1, S 256, hd 128
        ("yi-9b", "bfloat16", 1, SERVERLESS_PROMPT, 32, 4, 128, True, 0),
        ("codeqwen1.5-7b", "bfloat16", 1, SERVERLESS_PROMPT, 32, 32, 128, True, 0),
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
        if label == "main":
            main_args["flash_attention"] = (q, k, v, causal, window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        masked = 0 < window < S  # a window no shorter than S masks nothing
        if masked:  # SDPA has no window: an explicit mask of the visible pairs
            qp, kp = torch.arange(S, device=dev)[:, None], torch.arange(S, device=dev)[None]
            mask = (kp > qp - window) & ((kp <= qp) if causal else True)
            sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                     attn_mask=mask, enable_gqa=True)
        else:
            sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                     is_causal=causal, enable_gqa=True)
        row = _timing_row(
            "flash_attention", f"{label} {desc}", dt,
            lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
            lambda: flash_attention_ref(q, k, v, causal=causal, window=window),
            sdpa, "sdpa" + (" (explicit window mask)" if masked else ""),
            2 * (B * S * H * hd + B * S * K * hd) * q.element_size(),
            4 * B * H * hd * visible_pairs(S, causal, window), err)
        del ref
        if label != "long":
            rows[("flash_attention", label)] = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:102",
                "shape": SHAPE_NOTES[label], **row}
    dispatch_cost(main_args)
    rows.update(check_moe_experts())
    rows.update(check_rope_kv_write())
    rows.update(check_add_rms_norm())
    rows.update(check_mla_kernels())
    return rows


MLA_MODEL = "deepseek-v2-lite"
MLA_TABLE = 2048  # pages of 16 the benchmark cell's table holds (16,448 tokens)
MLA_LENGTH = 16448  # the cell's longest context: 16,384 prompt + 64 decoded
MLA_PROMPT = 16384
MLA_PLAIN_PROMPT = 4096  # K2's plain version: its 16,384^2 float32 scores take 17 GB a copy
MLA_PLAIN_BLOCK = 1024  # query rows of K2 checked at once past it: 16 x 1,024 x 16,384 scores, 1 GB


def _causal_rows(q, k, v, scale, rows: slice):
    """The plain version's formula (`flash_attention_ref`: float32 scores,
    P in q's dtype) for query rows `rows` alone of a causal call at B 1 with
    as many kv heads as query heads, over keys [0, rows.stop)."""
    import torch

    end = rows.stop
    s = torch.einsum("rhd,thd->hrt", q[0, rows].float(), k[0, :end].float()) * scale
    qp = torch.arange(rows.start, end, device=q.device)[:, None]
    s = s.masked_fill(torch.arange(end, device=q.device)[None] > qp, float("-inf"))
    p = torch.softmax(s, -1).to(q.dtype)
    return torch.einsum("hrt,thd->rhd", p, v[0, :end])


def _check_rows(name: str, out, want, dt: str, desc: str) -> float:
    """Max abs error of a block of a kernel's output against its plain
    version, as a share of the block's largest output; raises past the
    tolerance (late query rows average thousands of values, so their
    outputs are a few hundredths, and an absolute error would pass them)."""
    err = float((out.float() - want.float()).abs().max())
    rel = err / float(want.float().abs().max())
    line = (f"[kernel] {name} {desc}: max_abs_err {err:.3e}, {rel:.3e} of the block's scale "
            f"(tol {TOL[dt]:g})")
    log(line)
    if not rel < TOL[dt]:
        raise AssertionError(f"{name} disagrees with its plain version: {line}")
    return rel


def check_mla_kernels() -> dict:
    """K1's latent mode and K2 at split widths against their plain versions
    and timed at the benchmark cell's shapes (`[timing]` rows): the latent
    decode attention of one layer at B 1 over 16,448 tokens beside SDPA
    over the pre-gathered latent rows, and the un-absorbed prefill
    attention at S 16,384 (q/k 192, v 128) beside SDPA (v at 128, the
    installed torch taking unequal widths).  K2's plain version holds its
    first MLA_PLAIN_PROMPT query rows whole, then a middle block and the
    last block of rows each against its own output scale.  Returns the two
    rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import visible_pairs
    from repro_torch.kernels.ref import flash_attention_ref, paged_latent_attention_ref
    from repro_torch.models import layers

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(28)
    cfg = get_config(MLA_MODEL)
    scale = layers.mla_softmax_scale(cfg)
    H, W, V = cfg.num_heads, cfg.latent_width, cfg.kv_lora_rank
    rows = {}
    # K1 latent: (B, table pages, lengths)
    for B, N, lengths in ((1, MLA_TABLE, [MLA_LENGTH]), (1, MLA_TABLE, [1]), (2, 64, [0, 1000]),
                          (3, 256, [4096, 17, 2500])):
        P = B * N + 3
        q = torch.randn((B, H, W), generator=gen).to(dev, torch.bfloat16)
        pages = torch.randn((P, 16, 1, W), generator=gen).to(dev, torch.bfloat16)
        tables = torch.randperm(P, generator=gen)[: B * N].reshape(B, N).to(dev, torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = ops.paged_latent_attention(q, pages, tables, lens, v_dim=V, scale=scale)
        ref = paged_latent_attention_ref(q, pages, tables, lens, v_dim=V, scale=scale)
        torch.cuda.synchronize()
        desc = f"latent bfloat16 B{B} H{H} W{W} V{V} T16 N{N} lengths {lengths}"
        err = _check("paged_attention", out, ref, "bfloat16", desc)
        if lengths != [MLA_LENGTH]:
            continue
        gathered = pages[tables[0].long()].reshape(-1, W)[:MLA_LENGTH][None, None]
        sdpa = functools.partial(F.scaled_dot_product_attention, q[0][None, None], gathered,
                                 gathered[..., :V], scale=scale)
        row = _timing_row(
            "paged_attention", f"{MLA_MODEL} {desc}", "bfloat16",
            lambda: ops.paged_latent_attention(q, pages, tables, lens, v_dim=V, scale=scale),
            lambda: paged_latent_attention_ref(q, pages, tables, lens, v_dim=V, scale=scale),
            sdpa, "sdpa over the pre-gathered latent rows",
            (H * W + H * V) * 2 + MLA_LENGTH * W * 2 + N * 4 + 4,
            2 * H * (W + V) * MLA_LENGTH, err)
        rows[("paged_attention", MLA_MODEL)] = {
            "name": "paged_attention (latent)", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu", "replaces": None,
            "shape": SHAPE_NOTES[MLA_MODEL], **row}
        del pages, ref, gathered
    # K2 at split widths: (S, the plain version's S)
    for S in (2048, MLA_PROMPT):
        q, k = (torch.randn((1, S, H, 192), generator=gen).to(dev, torch.bfloat16)
                for _ in range(2))
        v = torch.randn((1, S, H, 128), generator=gen).to(dev, torch.bfloat16)
        out = ops.flash_attention(q, k, v, causal=True, scale=scale)
        desc = f"split widths bfloat16 B1 S{S} H{H} q/k 192 v 128 causal"
        plain_s = min(S, MLA_PLAIN_PROMPT)
        qp, kp, vp = q[:, :plain_s], k[:, :plain_s], v[:, :plain_s]
        err = _check("flash_attention", out[:, :plain_s],
                     flash_attention_ref(qp, kp, vp, causal=True, scale=scale), "bfloat16", desc)
        if S > plain_s:  # a middle block and the last, whose key ranges are the longest
            for start in (S // 2 - MLA_PLAIN_BLOCK // 2, S - MLA_PLAIN_BLOCK):
                block = slice(start, start + MLA_PLAIN_BLOCK)
                _check_rows("flash_attention", out[0, block], _causal_rows(q, k, v, scale, block),
                            "bfloat16", f"{desc}, query rows {start}-{block.stop - 1}")
        if S != MLA_PROMPT:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = _timing_row(
            "flash_attention", f"{MLA_MODEL} {desc}", "bfloat16",
            lambda: ops.flash_attention(q, k, v, causal=True, scale=scale),
            lambda: flash_attention_ref(qp, kp, vp, causal=True, scale=scale),
            functools.partial(F.scaled_dot_product_attention, qt, kt, vt, is_causal=True,
                              scale=scale), "sdpa (v 128)",
            2 * S * H * (192 * 2 + 128 * 2), 2 * H * (192 + 128) * visible_pairs(S, True, 0),
            err, note=f"; the plain version's time is at S {plain_s}")
        rows[("flash_attention", MLA_MODEL)] = {
            "name": "flash_attention (split widths)", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": None,
            "shape": SHAPE_NOTES[MLA_MODEL], **row}
    return rows


MLA_LAYERS = 4  # the dense layer and three MoE layers, at full width
MLA_PHASE_PROMPT, MLA_PHASE_GEN, MLA_PHASE_REQUESTS = 2048, 16, 3


def mla_phase(device="cuda") -> dict:
    """`[mla]`: the `Gateway` over deepseek-v2-lite at full width in
    MLA_LAYERS layers (weights drawn on the card), three warm requests of a
    2,048-token prompt (a block table of 128) and 16 tokens: K2 runs at
    split widths once a layer a prefill, K1 in its latent mode once a layer
    a decode step (the counters `paged_attention.latent_launches` and
    `flash_attention.split_launches`), the second request's steps are all
    replays, and the first request's first decoded logits are those of the
    plain attention path within the bf16 tolerance.  Returns its launches
    by kernel, keyed by the model."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.trace import Request
    from repro_torch.kernels import ops
    from repro_torch.serverless.gateway import Gateway
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config(MLA_MODEL), num_layers=MLA_LAYERS)
    tree = draw_weights(cfg, 50, device)
    eng = Engine(16 << 30, device=device)
    eng.register(MLA_MODEL, cfg, init_fn=lambda: tree)
    gw = Gateway(eng, keep_alive="fixed:1000000", prompt_len=MLA_PHASE_PROMPT,
                 gen_tokens=MLA_PHASE_GEN)
    reqs = [Request(time=10.0 * i, model_id=MLA_MODEL, dataset="mla",
                    prompt_tokens=MLA_PHASE_PROMPT, output_tokens=MLA_PHASE_GEN, batch_size=1)
            for i in range(MLA_PHASE_REQUESTS)]
    ops.reset_launch_counts()
    graphs = []
    for r in reqs:
        gw.run_trace([r])
        g = eng.step_graphs
        graphs.append((g.eager_steps, g.captures, g.replays))
    torch.cuda.synchronize()
    made, modes = ops.launch_counts(), ops.mode_counts()
    n = MLA_PHASE_REQUESTS
    want = {"paged_attention.latent": MLA_LAYERS * MLA_PHASE_GEN * n,
            "flash_attention.split": MLA_LAYERS * n}
    norms = (2 * MLA_LAYERS + 1) * MLA_PHASE_GEN * n  # 2 L + 1 a decode step
    log(f"[mla] {n} requests, prompt {MLA_PHASE_PROMPT}, {MLA_PHASE_GEN} tokens: launches {made}, "
        f"modes {modes}; graphs (eager, captures, replays) after each {graphs}")
    if (modes != want or made["paged_attention"] != want["paged_attention.latent"]
            or made["rope_kv_write"] or made["add_rms_norm"] != norms):
        raise AssertionError(f"[mla] launches {made} {modes}, expected {want} and "
                             f"{norms} of add_rms_norm")
    if graphs[1][:2] != graphs[0][:2] or graphs[2][:2] != graphs[0][:2]:
        raise AssertionError(f"[mla] a warm request made eager steps or captures: {graphs}")
    # the first decoded logits against the plain attention path
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, MLA_PHASE_PROMPT),
                                     generator=torch.Generator().manual_seed(7),
                                     dtype=torch.int32).to(device)}
    firsts = {}
    for mode in ("kernel", "ref"):
        inst = eng.start_instance(MLA_MODEL, attn_mode=mode)
        tok = inst.prefill(batch).argmax(-1).to(torch.int32)
        firsts[mode] = inst.decode(tok).float()
        inst.finish()
    err = rel_err(firsts["kernel"], firsts["ref"])
    log(f"[mla] first decoded logits against the plain attention path: rel err {err:.3e}")
    if not err < TOL["bfloat16"]:
        raise AssertionError(f"[mla] kernel path leaves the plain path: {err}")
    eng.close()
    return {MLA_MODEL: {"paged_attention": made["paged_attention"],
                        "flash_attention": made["flash_attention"],
                        "add_rms_norm": made["add_rms_norm"]}}


def check_moe_experts() -> dict:
    """The routed experts against their plain version over routed and
    dropped pairs, timed at qwen3-moe-30b-a3b's B 1 decode and
    mixtral-8x7b's beside their bound (the routed weights once) and, as the
    yardstick, the slot path's expert products at the same shape (three
    bmm over every expert's `moe_capacity` slots and the SiLU.mul, what
    the layer ran before the kernel).  Returns the timed rows."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moe_experts_ref
    from repro_torch.models import layers

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    # (label, dtype, T, k, E, D, F, dropped pairs a token); the timed rows
    # are the decode steps of [families] and [state-families]
    cases = [("qwen3-moe-30b-a3b", "bfloat16", 1, 8, 128, 2048, 768, 0),
             ("", "bfloat16", 4, 8, 128, 2048, 768, 0),
             ("", "bfloat16", 12, 8, 128, 2048, 768, 3),
             ("mixtral-8x7b", "bfloat16", 1, 2, 8, 4096, 14336, 0),
             ("", "bfloat16", 3, 2, 8, 128, 64, 1),
             ("", "float32", 3, 2, 8, 128, 64, 1),
             ("", "float32", 2, 8, 128, 2048, 768, 0)]
    for label, dt, T, k, E, D, F, drop in cases:
        dtype = getattr(torch, dt)
        x = torch.randn((T, D), generator=gen, device=dev).to(dtype)
        ids = torch.stack([torch.randperm(E, generator=gen, device=dev)[:k] for _ in range(T)])
        w = torch.rand((T, k), generator=gen, device=dev)
        w = w / w.sum(-1, keepdim=True)
        keep = torch.ones((T, k), dtype=torch.bool, device=dev)
        keep[:, k - drop:] = False
        wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev) * D ** -0.5).to(dtype)
                  for _ in range(2))
        wd = (torch.randn((E, F, D), generator=gen, device=dev) * F ** -0.5).to(dtype)
        args = (x, ids, w, keep, wg, wu, wd)
        out = ops.moe_experts(*args)
        ref = moe_experts_ref(*args)
        torch.cuda.synchronize()
        err = _check("moe_experts", out, ref, dt, f"{dt} T{T} k{k} E{E} D{D} F{F}, "
                     f"{drop} of each token's pairs dropped")
        if not label:
            continue
        pairs = T * (k - drop)
        cap = layers.moe_capacity(T, k, E, layers.DECODE_CAPACITY_FACTOR)
        xe = torch.randn((E, cap, D), generator=gen, device=dev).to(dtype)
        p = {"wg": wg, "wu": wu, "wd": wd}
        row = _timing_row(
            "moe_experts", f"{label} {dt} T{T} k{k} E{E} D{D} F{F}", dt,
            lambda: ops.moe_experts(*args), lambda: moe_experts_ref(*args),
            lambda: layers._experts(xe, p), f"slot path (bmm x3 over {E} experts x {cap} slots)",
            pairs * 3 * D * F * x.element_size() + 2 * T * D * x.element_size(),
            pairs * 6 * D * F, err)
        rows[("moe_experts", label)] = {
            "name": "moe_experts", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_experts.cu", "replaces": None,
            "shape": SHAPE_NOTES[label], **row}
        del wg, wu, wd, xe, p, args
    return rows


def check_rope_kv_write() -> dict:
    """The paged decode step's rope + K/V write against its plain version
    (the chain of PyTorch kernels it replaced: `common.rope_apply` on q and
    k, two `index_copy_`), to the bit, at every served model's decode shape
    and at B 3 across a page boundary, timed beside its bound (q, k and v
    read and written, the table and rows read once).  No library call does
    its work.  Returns the timed rows."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rope_kv_write_ref
    from repro_torch.models import common

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    T, N = 16, 64
    # (label, B, H, K, hd, lengths, mrope_sections): the decode steps timed
    # for K1 above, at the same lengths
    cases = [("main", 4, 32, 8, 64, (545, 417, 233, 97), ()),
             ("deepseek-7b", 1, 32, 32, 128, (SERVERLESS_PROMPT + SERVERLESS_GEN,), ()),
             ("qwen3-moe-30b-a3b", 1, 32, 4, 128, (FAMILY_PROMPT + SERVERLESS_GEN,), ()),
             ("qwen2-vl-7b", 1, 28, 4, 128, (FAMILY_PROMPT + SERVERLESS_GEN,), (16, 24, 24)),
             ("yi-9b", 1, 32, 4, 128, (SERVERLESS_PROMPT + SERVERLESS_GEN,), ()),
             ("codeqwen1.5-7b", 1, 32, 32, 128, (SERVERLESS_PROMPT + SERVERLESS_GEN,), ()),
             ("", 3, 32, 8, 128, (15, 16, 1023), ())]
    for label, B, H, K, hd, lengths, sections in cases:
        q, k, v = (torch.randn((B, n, hd), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (H, K, K))
        P = B * N + 3
        tables = torch.randperm(P, generator=gen, device=dev)[: B * N].reshape(B, N)
        kp, vp = (torch.randn((P, T, K, hd), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
        row = tables[torch.arange(B, device=dev), (pos // T).long()] * T + (pos % T).long()
        rp = pos[None, :, None].expand(3, B, 1) if sections else pos[:, None]
        cos, sin = (t.reshape(B, hd // 2).contiguous()
                    for t in common.rope_table(rp, hd, 10_000.0, sections))
        kp_ref, vp_ref = kp.clone(), vp.clone()
        want = rope_kv_write_ref(q, k, v, cos, sin, row, kp_ref, vp_ref)
        got = ops.rope_kv_write(q, k, v, cos, sin, row, kp, vp)
        torch.cuda.synchronize()
        desc = f"bfloat16 B{B} H{H} K{K} hd{hd} lengths {list(lengths)}" + (
            f" M-RoPE {sections}" if sections else "")
        equal = (torch.equal(got, want) and torch.equal(kp, kp_ref)
                 and torch.equal(vp, vp_ref))
        log(f"[kernel] rope_kv_write {desc}: bitwise equal to its plain version {equal}")
        if not equal:
            raise AssertionError(f"rope_kv_write leaves its plain version at {desc}")
        if not label:
            continue
        args = (q, k, v, cos, sin, row, kp, vp)
        nbytes = (2 * B * (H + 2 * K) * hd * q.element_size()  # q, k, v read and written
                  + 2 * B * hd // 2 * cos.element_size() + B * row.element_size())
        row_ = _timing_row("rope_kv_write", f"{label} {desc}", "bfloat16",
                           lambda: ops.rope_kv_write(*args), lambda: rope_kv_write_ref(*args),
                           None, "", nbytes, 6 * B * (H + K) * hd // 2, 0.0)
        rows[("rope_kv_write", label)] = {
            "name": "rope_kv_write", "route": "cuda",
            "source": "src/repro_torch/csrc/rope_kv_write.cu", "replaces": None,
            "shape": SHAPE_NOTES[label], **row_}
    return rows


def bf16_steps(a, b):
    """Bfloat16 steps between `a` and `b`, element by element (0 for equal
    bits; +0 and -0 equal)."""
    import torch

    def key(t):  # the bit patterns, ordered as the values are
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (key(a) - key(b)).abs()


ADD_NORM_SHARE = 1e-3  # of the norm's elements a bfloat16 step off the chain's


def check_add_rms_norm() -> dict:
    """The paged decode step's add + RMSNorm against its plain version (the
    chain of PyTorch kernels it replaced: the add, then `common.rms_norm`)
    at every served width (D 2048, 3584, 4096), at B 1 and 4, with and
    without the add: h + delta to the bit, the norm within one bfloat16
    step an element, at most `ADD_NORM_SHARE` of them off (the kernel sums
    the squares over D in another order).  Timed at every served model's
    decode shape beside its bound (h and delta read, both outputs written,
    the scale read).  No library call does its work.  Returns the timed
    rows."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import add_rms_norm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    eps = 1e-6
    # (label, B, D): the decode steps timed for K1 above, then the other
    # batch of each served width
    cases = [("main", 4, 2048), ("deepseek-7b", 1, 4096), ("qwen3-moe-30b-a3b", 1, 2048),
             ("qwen2-vl-7b", 1, 3584), ("yi-9b", 1, 4096), ("codeqwen1.5-7b", 1, 4096),
             (MLA_MODEL, 1, 2048), ("", 4, 3584), ("", 4, 4096), ("", 1, 2048)]
    for label, B, D in cases:
        h = (torch.randn((B, 1, D), generator=gen, device=dev) * 4).to(torch.bfloat16)
        delta = (torch.randn((B, 1, D), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        scale = torch.randn((D,), generator=gen, device=dev) * 0.1
        err = 0.0
        for d in (delta, None):
            want_h, want_x = add_rms_norm_ref(h, d, scale, eps)
            got_h, got_x = ops.add_rms_norm(h, d, scale, eps)
            steps = bf16_steps(got_x, want_x)
            err = max(err, float((got_x.float() - want_x.float()).abs().max()))
            share = float((steps > 0).float().mean())
            desc = f"bfloat16 B{B} D{D}" + ("" if d is not None else " norm only")
            log(f"[kernel] add_rms_norm {desc}: h + delta bitwise {torch.equal(got_h, want_h)}; "
                f"norm at most {int(steps.max())} bfloat16 step off, {share:.5f} of it")
            if not (torch.equal(got_h, want_h) and int(steps.max()) <= 1
                    and share <= ADD_NORM_SHARE):
                raise AssertionError(f"add_rms_norm leaves its plain version at {desc}")
        if not label:
            continue
        args = (h, delta, scale, eps)
        nbytes = 4 * B * D * h.element_size() + D * scale.element_size()
        row = _timing_row("add_rms_norm", f"{label} bfloat16 B{B} D{D}", "bfloat16",
                          lambda: ops.add_rms_norm(*args), lambda: add_rms_norm_ref(*args),
                          None, "", nbytes, 6 * B * D, err)
        rows[("add_rms_norm", label)] = {
            "name": "add_rms_norm", "route": "cuda",
            "source": "src/repro_torch/csrc/add_rms_norm.cu", "replaces": None,
            "shape": SHAPE_NOTES[label], **row}
    return rows


def _host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host time of one call of `fn` in microseconds: the least over
    `repeats` of `calls` back-to-back calls that are not waited on (their
    launches queue on the stream, so the device work is not in the time)."""
    import torch

    best = math.inf
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def dispatch_cost(main_args: dict):
    """Each kernel's host cost a call at the main path's shape: through its
    `torch.library` operator (the route of fake and meta tensors), through
    the bare launch, and through the wrapper the model calls (which launches
    directly on a plain CUDA tensor)."""
    import importlib

    import torch

    from repro_torch.kernels import ops

    # the modules (the package's attributes of these names are the wrappers)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    pa = importlib.import_module("repro_torch.kernels.paged_attention")

    q, k, v, causal, window = main_args["flash_attention"]
    args = main_args["paged_attention"]
    cases = {
        "paged_attention": (lambda: torch.ops.repro_torch.paged_attention(*args),
                            lambda: pa._launch(*args), lambda: ops.paged_attention(*args)),
        "flash_attention": (lambda: torch.ops.repro_torch.flash_attention(q, k, v, causal, window),
                            lambda: fa._launch(q, k, v, causal, window),
                            lambda: ops.flash_attention(q, k, v, causal=causal, window=window)),
    }
    for name, (op, bare, wrapper) in cases.items():
        us = {what: _host_us(fn) for what, fn in
              (("operator", op), ("bare launch", bare), ("wrapper", wrapper))}
        log(f"[dispatch] {name} at the main path's shape, host time a call (least of 5 x 200 "
            "calls not waited on): " + ", ".join(f"{w} {t:.2f} us" for w, t in us.items())
            + f"; the operator's dispatch adds {us['operator'] - us['bare launch']:.2f} us")


SHAPE_NOTES = {"main": "llama3.2-1b, main path (launches: main path)",
               "deepseek-7b": "deepseek-7b, [serverless] (launches: its requests there)",
               "qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b (12 of 48 layers), [families] "
                                    "(launches: its requests there)",
               "qwen2-vl-7b": "qwen2-vl-7b, [families] (launches: its requests there)",
               "yi-9b": "yi-9b, [dense] (launches: its requests there)",
               "codeqwen1.5-7b": "codeqwen1.5-7b, [dense] (launches: its requests there)",
               "recurrentgemma-9b": "recurrentgemma-9b, [state-families] (launches: its "
                                    "requests there)",
               "recurrentgemma-9b long": "recurrentgemma-9b, [state-families] 2200-token "
                                         "probe (launches: the probe's kernel path)",
               "mixtral-8x7b": "mixtral-8x7b (6 of 32 layers), [state-families] "
                               "(launches: its requests there)",
               "mixtral-8x7b long": "mixtral-8x7b (6 of 32 layers), [state-families] "
                                    "4200-token probe (launches: the probe's kernel path)",
               "whisper-tiny": "whisper-tiny encoder, [state-families] (launches: its "
                               "requests there, encoder and decoder self-attention)",
               "distributed": "llama3.2-1b, [distributed] prefill step on a 1x1 mesh "
                              "(launches: the phase's, 2 calls of the step, K2 through "
                              "local_map, and 1 of Model.prefill)",
               "deepseek-v2-lite": "deepseek-v2-lite, the benchmark cell's shapes: K1 latent "
                                   "B 1 over 16,448 tokens, K2 at S 16,384 (launches: [mla], "
                                   "4 of 27 layers, 3 requests)"}


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
        assert counts["rope_kv_write"] == L * decode_dispatches, counts
        assert counts["add_rms_norm"] == (2 * L + 1) * decode_dispatches, counts
        assert counts["flash_attention"] == L * prefills, counts

    for i, lg in enumerate(step_logits):
        assert lg.shape == (B, cfg.padded_vocab)
        assert bool(torch.isfinite(lg.float()).all()), f"non-finite logits at step {i}"
    if eng.step_graphs is not None:
        log(f"[main] decode step graphs: {graph_stats(eng.step_graphs)}")
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


def profile_steps(inst, prefill, steps: int, tag: str, what: str, decode_what: str):
    """Where the time goes: torch.profiler over `prefill()` (which returns
    the prompt's logits) and then `steps` decode steps of `inst`, outside
    any counted path, after two unprofiled steps (on a graphed engine the
    key's eager first call and its capture); logs walls, device busy time,
    the idle share, kernels a step, K2's and K1's share and the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok = prefill().argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = _device_ms(prof, 1)
    if by_name:
        busy_ms = sum(by_name.values())
        k2_ms = sum(t for n, t in by_name.items() if "flash_bf16_kernel" in n)
        log(f"[{tag}] prefill {what} (profiled): wall {prefill_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, {n_kernels} kernels, K2 {k2_ms:.3f} ms")
    for _ in range(2):
        tok = inst.decode(tok).argmax(-1).to(torch.int32)
    profile_decode_steps(inst, tok, steps, tag, decode_what)


def profile_decode_steps(inst, tok, steps: int, tag: str, what: str) -> dict:
    """torch.profiler over `steps` decode steps of `inst` from `tok`: wall,
    device busy time, the idle share, kernels a step, K1's share and the
    largest kernels, logged and returned (empty where the profiler saw no
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = inst.decode(tok).argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, n_kernels = _device_ms(prof, steps)
    if not by_name:
        log(f"[{tag}] decode: device time not measured (the profiler saw no CUDA events)")
        return {}
    busy_ms = sum(by_name.values())
    k1_ms = sum(t for n, t in by_name.items() if "paged_attention_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{tag}] decode {what} (profiled): wall {wall_ms:.3f} ms/step, "
        f"device busy {busy_ms:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{n_kernels / steps:.0f} kernels/step, K1 {k1_ms:.3f} ms/step; top: "
        + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "kernels": n_kernels / steps,
            "copy_ms": sum(t for n, t in by_name.items() if n.startswith("Memcpy"))}


def profile_decode(eng, cfg, batch, steps: int = 8):
    """The main path's warm prefill and `steps` decode steps of a fresh
    instance under the profiler (`profile_steps`), the decode step eager or
    graphed as `eng` runs it."""
    inst = eng.start_instance(cfg.name, max_blocks_per_seq=64, num_pages=256)
    route = "eager" if eng.step_graphs is None else "graphed"
    profile_steps(inst, lambda: inst.prefill(batch, lengths=PROMPT_LENS), steps, "profile",
                  f"B={len(PROMPT_LENS)} S={max(PROMPT_LENS)}",
                  f"B={len(PROMPT_LENS)} {route}")
    inst.finish()


def profile_states(eng, names, steps: int = 8):
    """Each non-paged model's prefill of the phase's prompt and `steps`
    decode steps at B 1 under the profiler (`profile_steps`)."""
    from repro_torch.serverless.gateway import make_prefill_batch

    for m in names:
        eng.load(m)  # its instance's finish releases it
        inst = eng.start_instance(m)
        batch = make_prefill_batch(eng, m, STATE_PROMPT, 0)
        profile_steps(inst, lambda: inst.prefill(batch), steps, "state-families",
                      f"{m} B=1 S={STATE_PROMPT}", f"{m} B=1")
        inst.finish()


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
# [families]: qwen3-moe-30b-a3b cut to 12 of its 48 layers (16.2 of 61.1 GB,
# so the weights drawn on the card and kept page-locked on the host fit the
# machine) and qwen2-vl-7b whole; 512-token prompts, so 256 text tokens
# follow the 256 vision patches.  Seed 25 of the 20 s Poisson trace at 8
# requests gives, under the 10 s keep-alive, full h2d cold starts (0, 1),
# partial-reuse cold starts (2, 4, 5), warm starts (3, 6) and a cold start
# that finds the whole model still in the pool (7), and no arrival finds the
# other model warm (the pool cannot hold both retained).
FAMILY_MODELS = ("qwen3-moe-30b-a3b", "qwen2-vl-7b")
FAMILY_MOE_LAYERS = 12
FAMILY_TRACE = dict(n_requests=8, seed=25, mean_interarrival=20.0)
FAMILY_PROMPT = 512
# [state-families]: the families of the Engine's non-paged fallback at full
# width, mixtral-8x7b cut to 6 of its 32 layers (17.94 of 93.41 GB; the
# whole model does not fit one card); the pool holds mixtral and half of
# recurrentgemma-9b, so the two never co-reside.  Seed 39 of the 20 s
# Poisson trace over this model order (Zipf popularity: mixtral first) gives
# under the 10 s keep-alive full h2d cold starts of all four models,
# partial-reuse cold starts and a warm start, and no arrival finds mixtral
# or recurrentgemma warm while the other is requested.  Then one prompt per
# SWA model longer than its window.
STATE_MODELS = ("mixtral-8x7b", "recurrentgemma-9b", "mamba2-2.7b", "whisper-tiny")
STATE_MIXTRAL_LAYERS = 6
STATE_TRACE = dict(n_requests=10, seed=39, mean_interarrival=20.0)
STATE_PROMPT = 512
STATE_LONG = {"recurrentgemma-9b": 2200, "mixtral-8x7b": 4200}
# [dedup]: deepseek-7b's fine-tune variants, each differing from the base in
# layer-stacked wq and wo (2,013,265,920 of 13,821,231,104 B)
DEDUP_VARIANTS = 3
DEDUP_DELTAS = ("segments/0/0/attn/wq", "segments/0/0/attn/wo")
KV_ROOM = 512 << 20  # pool bytes left for one request's KV beside the weights
# [migration]: decode steps on the source before the snapshot; the window
# replayed on the target is the fleet's `migrate_replay_tokens` default
MIGRATE_BEFORE, MIGRATE_WINDOW = 8, 4
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


def release_memory():
    """Give back what finished phases freed: device blocks PyTorch's caching
    allocator holds, and the page-locked host blocks its host allocator
    caches (freed pinned tensors otherwise stay resident in this process)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is None:
        log("[memory] this torch cannot empty its page-locked host cache")
    else:
        empty_host()


def allocated(dev) -> int:
    """Device bytes the live tensors requested, once the card is idle and
    unreachable Python objects are collected, without the cuBLAS
    workspaces: a decode-step capture clears them (`serving/step_graph.py`)
    and the next eager matmul allocates its stream's anew (32 MiB on
    Hopper), so they come and go between any two readings.  Requested, not
    allocated, bytes: the caching allocator may place a tensor in a larger
    cached block than it asked for, by up to 1 MiB, as its cache happens
    to be fragmented."""
    import torch

    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


def device_bytes(eng) -> int:
    """Bytes of every device tensor the engine holds: its pool's buffers, KV
    slabs, fused tables, captured decode steps' static buffers and live
    instances' tables."""
    import torch

    tensors = list(eng._tensors.values())
    for slab in eng._slabs.values():
        tensors += list(slab.pages)
    for cached in eng._fused.values():
        tensors += [t for t in cached if isinstance(t, torch.Tensor)]
    if eng.step_graphs is not None:  # captured steps' static buffers
        for g in eng.step_graphs.live():
            tensors += list(g.inputs + g.outputs)
    for insts in eng._live_instances.values():
        for inst in insts:
            tensors += [t for t in (inst._tables, inst._lengths) if t is not None]
            if inst._cache is not None:
                # a non-paged instance's state caches and rings: outside the
                # pool's ledger (ElasticKV allocates nothing for them)
                tree_map(tensors.append, inst._cache)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if t.device.type == "cuda"}
    return sum(storages.values())


# PyTorch's CUDA generator holds a graph-safe seed and offset (two int64
# tensors) while any graph is registered with it
RNG_GRAPH_STATE_BYTES = 16


def live_bytes(g) -> int:
    """Device bytes the live keys of `g` account for: their static tensors
    (`StepGraphs.static_bytes`) and the generator's graph state."""
    return g.static_bytes() + (RNG_GRAPH_STATE_BYTES if g.live() else 0)


def recording_engine():
    """`Engine` that ledgers every load, counts each model's kernel launches
    (the launch counters read when an instance starts and when it finishes),
    and keeps, for the first instance of each model, the prompt batch, the
    fed token and clones of the first prefill and decode logits (device
    copies: no host read).  Per instance it records the eager steps,
    captures and replays its decode made (`requests`) and whether it found
    its key live: the model's params tree and slab unchanged since its
    previous instance, which decoded long enough to capture; for the first
    such instance of each model it keeps the prompt, the fed tokens and
    every decode logit (`live_first`).  The hooks hold their instance
    weakly, so a finished instance is freed at once."""
    import weakref

    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    class RecordingEngine(Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.loads, self.first = [], {}
            self.launches, self._launches_at = {}, {}
            self.requests, self.live_first = [], {}
            self._graphs_at, self._key_of = {}, {}

        def _graph_counts(self):
            g = self.step_graphs
            return (0, 0, 0) if g is None else (g.eager_steps, g.captures, g.replays)

        def load(self, model_id, **kw):
            rep = super().load(model_id, **kw)
            self.loads.append((model_id, rep, self.last_load))
            return rep

        def finish_instance(self, model_id):
            super().finish_instance(model_id)
            started = self._graphs_at.pop(model_id, None)
            if started is not None:
                counts, live = started
                made = [n - n0 for n, n0 in zip(self._graph_counts(), counts)]
                self.requests.append(dict(zip(("eager", "captures", "replays"), made),
                                          model=model_id, live=live))
            at = self._launches_at.pop(model_id, None)
            if at is None:  # an instance the crash already dropped
                return
            mine = self.launches.setdefault(model_id, dict.fromkeys(at, 0))
            for k, n in ops.launch_counts().items():
                mine[k] += n - at[k]

        def start_instance(self, model_id, **kw):
            self._launches_at[model_id] = ops.launch_counts()
            inst = super().start_instance(model_id, **kw)
            key = (self._tree_of.get(model_id),
                   None if inst.slab is None else inst.slab.pages[0].data_ptr())
            live = self.step_graphs is not None and self._key_of.get(model_id) == key
            self._key_of[model_id] = key
            self._graphs_at[model_id] = (self._graph_counts(), live)
            if live and model_id not in self.live_first:
                self._keep_live(model_id, inst, kw)
            if model_id in self.first:
                return inst
            rec = self.first[model_id] = {}
            ref = weakref.ref(inst)

            def first_prefill(batch, **k):
                out = type(ref()).prefill(ref(), batch, **k)
                rec.update(batch=batch, prefill=out.detach().clone(),
                           ring=ring_slots(ref()))
                return out

            def first_decode(tok):
                out = type(ref()).decode(ref(), tok)
                if "decode" not in rec:
                    rec.update(token=tok.clone(), decode=out.detach().clone())
                return out

            inst.prefill, inst.decode = first_prefill, first_decode
            return inst

        def _keep_live(self, model_id, inst, kw):
            rec = self.live_first[model_id] = {"kw": kw, "tokens": [], "decode": []}
            ref = weakref.ref(inst)

            def prefill(batch, **k):
                rec.update(batch=batch, prefill_kw=k)
                return type(ref()).prefill(ref(), batch, **k)

            def decode(tok):
                out = type(ref()).decode(ref(), tok)
                rec["tokens"].append(tok.clone())
                rec["decode"].append(out.detach().clone())
                return out

            inst.prefill, inst.decode = prefill, decode

    return RecordingEngine


def ring_slots(inst):
    """Slots of a non-paged instance's attention cache (its SWA ring or the
    decoder's self-attention cache); None for a paged instance."""
    cache = inst._cache
    if cache is None:
        return None
    if isinstance(cache, dict):  # encoder-decoder
        return int(cache["self_k"].shape[2])
    rings = {int(unit["k"].shape[2]) for seg in cache for unit in seg if "k" in unit}
    return min(rings) if rings else None


def kernel_launches(cfg, requests: int, gen: int) -> dict:
    """Launches each kernel makes serving `requests` requests of `gen`
    tokens: K2 once per attention layer per prefill (the encoder's layers
    too), K1 and the rope + K/V write once per layer per decode step on the
    paged path only (the non-paged fallback decodes with the plain dense
    attention, as the reference does; a latent-attention model's paged step
    writes its latent rows without the rope + K/V write), the add + RMSNorm
    2 L + 1 times a paged decode step, the routed experts once per MoE
    layer per decode step on both paths."""
    from repro_torch.serving.engine import _is_paged_family

    flash = sum(k in ("attn", "swa") for k in cfg.pattern)
    if cfg.family == "audio":
        flash += cfg.encoder_layers
    paged = cfg.num_layers * gen if _is_paged_family(cfg) else 0
    # the routed experts: one call a MoE layer a decode step at B 1 (T * k < E)
    routed = (cfg.num_layers * gen if cfg.is_moe and cfg.experts_per_token < cfg.num_experts
              else 0)
    norms = (2 * cfg.num_layers + 1) * gen if _is_paged_family(cfg) else 0
    return {"paged_attention": paged * requests, "flash_attention": flash * requests,
            "moe_experts": routed * requests,
            "rope_kv_write": 0 if cfg.is_mla else paged * requests,
            "add_rms_norm": norms * requests}


@contextlib.contextmanager
def router_choices(record=None, replay=None):
    """Record the expert choices of every MoE layer (`torch.topk` in
    `moe_forward`, the only top-k of a forward) into `record`, or make them
    the ones in `replay`, in call order, each weighted by the router's own
    probabilities; a replayed choice takes the leading dims of the
    probabilities it replaces (the GShard dispatch routes (B, S, E), the
    others (B*S, E)).  Only for holding a path against another: in bf16 a
    token whose k-th and (k+1)-th expert probabilities nearly tie may be
    routed either way by two paths that round differently."""
    import torch

    real = torch.topk
    calls = iter(replay) if replay is not None else None

    def topk(x, k, dim=-1, **kw):
        if calls is not None:
            idx = next(calls).reshape(*x.shape[:-1], k)
            return x.gather(dim, idx), idx
        out = real(x, k, dim=dim, **kw)
        record.append(out.indices.clone())
        return out

    torch.topk = topk
    try:
        yield
    finally:
        torch.topk = real


def first_logits(eng, m, batch, token, plain=False) -> dict:
    """Prefill and first-decode logits of a fresh instance of `m`; `plain`
    runs both through the plain attention (flash and paged)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    inst = eng.start_instance(m, attn_mode="ref" if plain else "kernel")
    kernel = ops.flash_attention
    if plain:
        ops.flash_attention = flash_attention_ref  # the plain prefill path
    try:
        out = {"prefill": inst.prefill(batch)}
    finally:
        ops.flash_attention = kernel
    out["decode"] = inst.decode(token)
    inst.finish()
    return out


def rel_err(got, want) -> float:
    """max |diff| / max(1, max |want|)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def hold_first_tokens(eng, names, tag="serverless"):
    """The first request of each model through the plain attention (flash
    and paged) on the same engine, weights, prompt and fed token: its first
    prefill and decode logits within the bf16 tolerance relative to scale.
    A MoE model's plain run takes the expert choices of a rerun of its
    kernel path (which must give the first request's logits again)."""
    worst = {}
    for m in names:
        rec = eng.first[m]
        eng.load(m)
        route = []
        held = rec
        moe = eng.models[m].cfg.is_moe
        # a MoE model's runs on the eager step, so the router hook sees it
        with eager_steps(eng) if moe else contextlib.nullcontext():
            if moe:
                with router_choices(record=route):
                    held = first_logits(eng, m, rec["batch"], rec["token"])
                for step in ("prefill", "decode"):
                    err = rel_err(held[step], rec[step])
                    worst[(m, f"{step} rerun")] = err
                    assert err <= TOL["bfloat16"], f"{m} {step} rerun: {err}"
            replay = router_choices(replay=route) if route else contextlib.nullcontext()
            with replay:
                plain = first_logits(eng, m, rec["batch"], rec["token"], plain=True)
        eng.release(m)
        for step, want in plain.items():
            worst[(m, step)] = err = rel_err(held[step], want)
            assert err <= TOL["bfloat16"], f"{m} {step}: logits differ by {err} of scale"
    log(f"[{tag}] first request of each model vs the plain attention path: "
        + ", ".join(f"{m} {step} {e:.3e}" for (m, step), e in worst.items())
        + f" (max |diff| / scale, tol {TOL['bfloat16']:g})")


def hold_live_requests(eng, tag):
    """Each model's first request on a live key (its decode replayed from
    the first step) run again on the eager step, over the same prompt and
    the same fed tokens: its logits bitwise equal, else within the bf16
    tolerance of scale, and each greedy token it fed the eager step's, or a
    tie within that tolerance."""
    import torch

    if not eng.live_first:
        log(f"[{tag}] no request found its key live")
        return
    lines = []
    with eager_steps(eng):
        for m, rec in eng.live_first.items():
            eng.load(m)
            inst = eng.start_instance(m, **rec["kw"])
            inst.prefill(rec["batch"], **rec["prefill_kw"])
            eager = [inst.decode(tok) for tok in rec["tokens"]]
            inst.finish()
            eng.release(m)
            match = logits_match(tag, f"{m} live-key request", rec["decode"], eager)
            ties = 0
            for i, (e, fed) in enumerate(zip(eager[:-1], rec["tokens"][1:])):
                e = e.float()
                want = e.argmax(-1).to(torch.int32)
                for b in torch.nonzero(want != fed).flatten().tolist():
                    gap = float(e[b, want[b]] - e[b, fed[b]])
                    scale = max(1.0, float(e.abs().max()))
                    assert gap <= TOL["bfloat16"] * scale, (tag, m, i, b, gap)
                    ties += 1
            lines.append(f"{m} {len(eager)} steps: {match}, {ties} greedy ties")
    eng.live_first.clear()  # device copies the crash check must not count
    log(f"[{tag}] each model's first live-key request against the eager step over its "
        f"prompt and tokens: " + "; ".join(lines))


def _load_line(i, rec, load, size, steps) -> str:
    m, rep, st = load
    assert steps["model"] == m, (i, steps, m)
    return (f"req {i}: {m:12s} {'cold' if rec.cold else 'warm'} "
            f"reuse {rep.reuse_fraction:.4f}; bytes device-hit {st.bytes_device_hit} "
            f"h2d {st.bytes_h2d} (host {st.bytes_host_hit}, store {st.bytes_store}, "
            f"prefetched {st.bytes_prefetched}, materialized leaves "
            f"{st.leaves_materialized}) of {size}; init {rec.init_s * 1e3:.3f} ms, "
            f"load {rec.load_s * 1e3:.3f} ms (h2d {st.transfer_seconds * 1e3:.3f} ms), "
            f"profile {rec.profile_s * 1e3:.3f} ms, prefill {rec.prefill_s * 1e3:.3f} ms, "
            f"decode {rec.decode_s / max(SERVERLESS_GEN, 1) * 1e3:.3f} ms/token, "
            f"TTFT {rec.ttft * 1e3:.3f} ms; decode steps: {steps['eager']} eager, "
            f"{steps['captures']} captures, {steps['replays']} replays (key "
            f"{'live' if steps['live'] else 'fresh'})")


def check_live_keys(tag, steps):
    """Every request whose model's params tree and slab were unchanged since
    its previous request replays its decode from the first step: 0 eager
    steps, 0 captures."""
    live = [i for i, s in enumerate(steps) if s["live"]]
    for i in live:
        assert (steps[i]["eager"], steps[i]["captures"]) == (0, 0), (tag, i, steps[i])
    log(f"[{tag}] requests on a live key (tree and slab unchanged since the model's previous "
        f"request): {live} of {len(steps)}, each 0 eager steps and 0 captures")


def check_loads(loads, sizes):
    """Every load moves exactly the bytes its report transfers, and the
    device hits plus the h2d bytes are the whole model."""
    for m, rep, st in loads:
        assert st.bytes_device_hit + st.bytes_h2d == sizes[m], (m, st.as_dict())
        assert st.bytes_h2d == rep.bytes_transferred, (m, st.bytes_h2d, rep.bytes_transferred)


def model_sizes(cfgs: dict) -> dict:
    from repro_torch.models.tensors import spec_records

    return {m: sum(r.nbytes for r in spec_records(m, cfg)) for m, cfg in cfgs.items()}


def serverless_phase(cfgs: dict, weights: dict, device="cuda", *, tag="serverless",
                     trace_kw=None, prompt=None, pool=None, probe=None) -> dict:
    """The single-engine `Gateway` over `cfgs` (`[serverless]`, and with
    `tag`, `trace_kw`, `prompt` and `pool` the `[families]` and
    `[state-families]` phases; `probe(eng)` runs on the engine before its
    crash and returns more launch counts); returns the launch counts of each
    model's requests, as the counters measured them."""
    import torch

    from repro_torch.core.trace import SimModel
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _print_ttft_breakdown
    from repro_torch.serverless import Gateway, poisson_trace

    trace_kw = trace_kw or SERVERLESS_TRACE
    prompt = prompt or SERVERLESS_PROMPT
    dev = torch.device(device)
    names = list(cfgs)
    sizes = model_sizes(cfgs)
    pool = pool or max(sizes.values()) + min(sizes.values()) // 2  # never both models
    eng = recording_engine()(pool, device=dev, engine_id=tag)
    for m in names:
        eng.register(m, cfgs[m], init_fn=lambda w=weights[m]: w)
    gc.collect()  # what earlier phases left in reference cycles
    base = allocated(dev)
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in names], **trace_kw)
    gw = Gateway(eng, keep_alive=SERVERLESS_KEEP_ALIVE, prompt_len=prompt,
                 gen_tokens=SERVERLESS_GEN)
    log(f"[{tag}] pool {pool} B; models {sizes}; trace {trace_kw}, keep-alive "
        f"{SERVERLESS_KEEP_ALIVE}, prompt {prompt}, {SERVERLESS_GEN} tokens")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sink = gw.run_trace(trace)
    replay_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_model = {m: dict(c) for m, c in eng.launches.items()}
    recs = sink.records
    steps = eng.requests[:]
    assert len(recs) == len(eng.loads) == len(trace) == len(steps)
    for i, (rec, load) in enumerate(zip(recs, eng.loads)):
        log(f"[{tag}] " + _load_line(i, rec, load, sizes[load[0]], steps[i]))
    check_loads(eng.loads, sizes)
    check_live_keys(tag, steps)
    kinds = {"warm": [i for i, r in enumerate(recs) if not r.cold],
             "full h2d cold": [i for i, (r, (m, _, st)) in enumerate(zip(recs, eng.loads))
                               if r.cold and st.bytes_h2d == sizes[m]],
             "partial-reuse cold": [i for i, (r, (_, rep, _)) in enumerate(zip(recs, eng.loads))
                                    if r.cold and 0 < rep.reuse_fraction < 1]}
    log(f"[{tag}] starts: {kinds}; replay {replay_s:.3f} s")
    assert all(kinds.values()), kinds
    expected = {m: kernel_launches(cfgs[m], sum(r.model_id == m for r in recs),
                                   SERVERLESS_GEN) for m in names}
    log(f"[{tag}] launches {json.dumps(counts)}; by model {json.dumps(per_model)} "
        f"(expected {json.dumps(expected)})")
    if dev.type == "cuda":
        assert per_model == expected, (per_model, expected)
        for k in counts:
            assert counts[k] == sum(c[k] for c in per_model.values()), (counts, per_model)
    rings = {m: eng.first[m]["ring"] for m in names if eng.first[m]["ring"] is not None}
    if rings:
        log(f"[{tag}] decode cache slots after a {prompt}-token prompt (the Engine's "
            f"cache_cap, round_up(S, {eng.block_tokens})): {json.dumps(rings)}")
    log(f"[{tag}] summary {json.dumps(sink.summary())}")
    _print_ttft_breakdown(recs)
    decode_floors(tag, cfgs, recs, steps)
    gw._expire(math.inf)  # the keep-alives lapse: the hold loads each model in turn
    hold_first_tokens(eng, names, tag)
    steady_decode(eng, cfgs, tag, prompt)
    hold_live_requests(eng, tag)
    if probe is not None:
        per_model.update(probe(eng))
    eng.crash()
    after = allocated(dev)
    log(f"[{tag}] crash: device memory {after} B allocated, {base} B before the first "
        f"load (one chunk = {CHUNK_BYTES} B)")
    assert after - base <= CHUNK_BYTES, (base, after)
    eng.close()
    return per_model


def weight_floor(m, cfg) -> tuple[int, float]:
    """Bytes a B 1 decode step must read and their time at the card's memory
    rate (ms): every weight once, of a MoE layer's experts the k its token
    is routed to (the routed path reads no other), the embedding table
    aside."""
    from repro_torch.models.tensors import spec_records

    routed = cfg.is_moe and cfg.experts_per_token < cfg.num_experts
    experts = ("/mlp/wg", "/mlp/wu", "/mlp/wd")
    nbytes = sum(r.nbytes * cfg.experts_per_token // cfg.num_experts
                 if routed and r.name.endswith(experts) else r.nbytes
                 for r in spec_records(m, cfg) if not r.name.endswith("/embed"))
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def decode_floors(tag, cfgs, recs, steps):
    """Each model's decode wall per token over its requests, split into
    those on a live key (every step a replay) and those on a fresh one (the
    key's eager first call and its capture among the steps), against its
    weight-read floor."""
    def span(walls):
        return (f"{min(walls):.3f}-{max(walls):.3f} ms over {len(walls)}" if walls
                else "none")

    for m, cfg in cfgs.items():
        nbytes, floor = weight_floor(m, cfg)
        walls = {kind: [r.decode_s / SERVERLESS_GEN * 1e3 for r, s in zip(recs, steps)
                        if r.model_id == m and s["live"] == (kind == "live")]
                 for kind in ("live", "fresh")}
        every = walls["live"] + walls["fresh"]
        log(f"[{tag}] {m}: decode {min(every):.3f}-{max(every):.3f} ms/token at B 1 (key live: "
            f"{span(walls['live'])}; key fresh: {span(walls['fresh'])}) against a weight-read "
            f"floor of {floor:.3f} ms ({nbytes} B a step)")


STEADY_STEPS = 16


def warm_steps(inst, tok):
    """Two untimed decode steps of `inst` from `tok` (its key's eager first
    call and its capture, or replays where the key is live); returns the
    token, settled, and whether the first step was a replay."""
    from repro_torch.serverless.gateway import greedy, settle

    g = inst.engine.step_graphs
    before = g.eager_steps if g is not None else 0
    tok = greedy(inst.decode(tok))
    live = g is not None and g.eager_steps == before
    return settle(greedy(inst.decode(tok))), live


def steady_decode(eng, cfgs, tag, prompt):
    """Each model's decode at B 1 once its step is captured (the paged step,
    or a state family's `Model.decode`): a fresh instance's prefill of the
    phase's prompt, two untimed steps (the key's eager first call and its
    capture, or replays where the key is still live, as the line says),
    then `STEADY_STEPS` replays timed sync-free, against the weight-read
    floor (`weight_floor`), and 8 more under the profiler; where the step
    ropes through `rope_kv_write`, 8 replays of a key captured with its
    plain version too (`plain_rope_kernels`)."""
    from repro_torch.serverless.gateway import greedy, make_prefill_batch, settle, sync_free
    from repro_torch.serving.engine import _is_paged_family

    for m, cfg in cfgs.items():
        eng.load(m)
        inst = eng.start_instance(m)
        tok = settle(greedy(inst.prefill(make_prefill_batch(eng, m, prompt, 0))))
        tok, live = warm_steps(inst, tok)
        t0 = time.perf_counter()
        with sync_free(tok.device):
            for _ in range(STEADY_STEPS):
                tok = greedy(inst.decode(tok))
        settle(tok)
        wall = (time.perf_counter() - t0) / STEADY_STEPS * 1e3
        nbytes, floor = weight_floor(m, cfg)
        route = ("eager" if eng.step_graphs is None
                 else f"graphed (key {'live' if live else 'fresh'} at its first step)")
        log(f"[{tag}] {m}: {route} decode {wall:.3f} ms/token at B 1 over {STEADY_STEPS} "
            f"steps after the capture, {wall / floor:.2f}x its weight-read floor of "
            f"{floor:.3f} ms")
        if tok.device.type == "cuda":
            prof = profile_decode_steps(inst, tok, 8, tag, f"{m} B=1 {route}")
            if prof:  # the profiler's own tracing lengthens the profiled wall
                log(f"[{tag}] {m}: device busy {prof['busy_ms']:.3f} ms against the "
                    f"unprofiled {wall:.3f} ms wall: idle share {1 - prof['busy_ms'] / wall:.3f}")
            if prof and eng.step_graphs is not None and _is_paged_family(cfg) and not cfg.is_mla:
                tok = plain_rope_kernels(inst, tok, tag, m, cfg, prof["kernels"])
        inst.finish()
        eng.release(m)


def plain_rope_kernels(inst, tok, tag, m, cfg, with_kernel: float):
    """Kernels the profiler sees in one replayed decode step of `inst` when
    the rope + K/V write's plain version (the chain of PyTorch kernels it
    replaced, the table still built once a step) stands in the kernel's
    place, against `with_kernel`, the count with the kernel: a key captured
    for the plain version, 8 of its replays profiled, then every key
    dropped, so later steps capture the kernel again.  Returns the token."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rope_kv_write_ref

    graphs = inst.engine.step_graphs
    real = ops.rope_kv_write
    graphs.drop()
    ops.rope_kv_write = rope_kv_write_ref
    try:
        tok, _ = warm_steps(inst, tok)
        prof = profile_decode_steps(inst, tok, 8, tag,
                                    f"{m} B=1 graphed, rope + K/V write by its plain version")
    finally:
        ops.rope_kv_write = real
        graphs.drop()
    if prof:
        fewer = prof["kernels"] - with_kernel
        log(f"[{tag}] {m}: kernels in one replayed step {with_kernel:.0f} with rope_kv_write, "
            f"{prof['kernels']:.0f} with its plain version: {fewer:.0f} fewer, "
            f"{fewer / cfg.num_layers:.1f} a layer of {cfg.num_layers}")
    return tok


def family_configs() -> dict:
    """qwen3-moe-30b-a3b at full width with 12 of its 48 layers, and
    qwen2-vl-7b whole."""
    import dataclasses

    from repro_torch.configs import get_config

    moe = get_config(FAMILY_MODELS[0])
    return {FAMILY_MODELS[0]: dataclasses.replace(moe, num_layers=FAMILY_MOE_LAYERS),
            FAMILY_MODELS[1]: get_config(FAMILY_MODELS[1])}


def families_phase(cfgs: dict, weights: dict, device="cuda") -> dict:
    """`[families]`: the `Gateway` over a MoE and a VLM model (`serverless_phase`
    with the families' trace and prompt)."""
    return serverless_phase(cfgs, weights, device, tag="families", trace_kw=FAMILY_TRACE,
                            prompt=FAMILY_PROMPT)


DENSE_MODELS = ("yi-9b", "codeqwen1.5-7b")


def dense_phase(cfgs: dict, weights: dict, device="cuda") -> dict:
    """`[dense]`: the `Gateway` over yi-9b (GQA, G 8; the reference's own
    serve_engine model) and codeqwen1.5-7b (MHA, G 1) at full width and
    depth, as `[serverless]` serves its pair: one pool that holds either
    model but not both, the seeded trace, every load's bytes, each model's
    first request against the plain attention path, K1 and K2 in every
    layer of every request."""
    return serverless_phase(cfgs, weights, device, tag="dense")


# ------------------------------------------------------------------ [trace]
TRACE_ARCH = "llama3.2-1b"
TRACE_DIR = ROOT / "build" / "trace"
TRACE_BATCH = 2
TRACE_STEPS = 3  # fused decode steps
TRACE_PHASES = ("store.read", "h2d", "h2d.chunk", "init", "profile", "load", "prefill")


def trace_phase(cfg, weights, device="cuda") -> dict:
    """`[trace]`: an `Engine` with a `Tracer` whose host tier holds nothing
    (every released leaf spills to the store tier): a cold load, the device
    copies dropped, a store-tier reload, a prefill and 3 fused decode steps
    (tests/test_fastpath.py's traced cold start, at full width).  Checks the
    span families, that each phase nests in its load and that the Chrome
    trace (written under build/trace) loads.  Returns the kernel launches."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.obs import FlightRecorder, Tracer, write_chrome_trace
    from repro_torch.serverless.gateway import greedy, settle
    from repro_torch.serving.engine import Engine

    dev, m = torch.device(device), cfg.name
    tracer = Tracer(flight=FlightRecorder())
    size = model_sizes({m: cfg})[m]
    eng = Engine(size + KV_ROOM, device=dev, host_cache_bytes=0, tracer=tracer,
                 engine_id="trace")
    eng.register(m, cfg, init_fn=lambda: weights)
    batch = build_model(cfg).make_batch(
        torch.Generator().manual_seed(5),
        ShapeConfig("trace", SERVERLESS_PROMPT, TRACE_BATCH, "prefill"), device=dev)
    ops.reset_launch_counts()
    eng.load(m)
    eng.drop_device_copies(m)
    eng.load(m)
    inst = eng.start_instance(m)
    tok = greedy(inst.prefill(batch))
    for _ in range(TRACE_STEPS):
        tok = greedy(eng.decode_many([(inst, tok)])[0])
    settle(tok)
    counts = ops.launch_counts()
    inst.finish()
    eng.close()

    events = tracer.events()
    by_name = {}
    for ev in events:
        by_name.setdefault(ev.name, []).append(ev)
    missing = [n for n in TRACE_PHASES if n not in by_name]
    assert not missing, f"cold-start phases never traced: {missing}"
    assert len(by_name["decode.step"]) == TRACE_STEPS, len(by_name["decode.step"])
    cold, reload_ = by_name["load"]
    assert cold.track == reload_.track == "eng:trace", (cold.track, reload_.track)
    (init,) = by_name["init"]
    (read,) = by_name["store.read"]
    assert cold.begin <= init.begin and init.end <= cold.end + 1e-6
    assert reload_.begin <= read.begin and read.end <= reload_.end + 1e-6
    assert read.args["bytes"] == size and read.args["retries"] == 0, read.args
    assert cold.args["pred"] > 0
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = write_chrome_trace(events, str(TRACE_DIR / f"{m}.json"))
    with open(path) as f:
        doc = json.load(f)["traceEvents"]
    spans = [e for e in doc if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 0 for e in spans) and any(e["ph"] == "M" for e in doc)
    families = {n: len(evs) for n, evs in sorted(by_name.items())}
    log(f"[trace] {m} at full width ({size} B): cold load {(cold.end - cold.begin) * 1e3:.3f} ms "
        f"(init {(init.end - init.begin) * 1e3:.3f} ms inside it), store-tier reload "
        f"{(reload_.end - reload_.begin) * 1e3:.3f} ms (store.read {read.args['bytes']} B in "
        f"{(read.end - read.begin) * 1e3:.3f} ms inside it), prefill B {TRACE_BATCH} S "
        f"{SERVERLESS_PROMPT}, {TRACE_STEPS} fused decode steps; launches {json.dumps(counts)}")
    log(f"[trace] wrote {path}: {len(spans)} spans {json.dumps(families)}")
    if dev.type == "cuda":
        want = {"paged_attention": cfg.num_layers * TRACE_STEPS,
                "flash_attention": cfg.num_layers, "moe_experts": 0,
                "rope_kv_write": cfg.num_layers * TRACE_STEPS,
                "add_rms_norm": (2 * cfg.num_layers + 1) * TRACE_STEPS}
        assert counts == want, (counts, want)
    return counts


# ------------------------------------------------------------------ [graphs]
GRAPH_STEPS = 32  # B 4 steps of one instance, then fused B 8 steps of two
GRAPH_EVICT_AT = 16  # the device copies are dropped and reloaded before this step


def graph_stats(g) -> str:
    return (f"{g.eager_steps} eager first calls, {g.captures} captures "
            f"({g.capture_seconds / max(g.captures, 1) * 1e3:.3f} ms and "
            f"{g.pool_bytes_captured // max(g.captures, 1)} B of private pool each), "
            f"{g.replays} replays, {g.dropped} dropped ({g.evicted} past the limit or the "
            f"budget), {len(g)} live holding {g.held_bytes()} B of a {g.budget} B budget")


def graph_run(eng, cfg, batch, fed=None) -> dict:
    """The main path's decode on `eng`: one instance at B 4 for
    `GRAPH_STEPS` steps, its model's device copies dropped and reloaded
    before step `GRAPH_EVICT_AT`, then a second instance and `GRAPH_STEPS`
    fused `decode_many` steps at B 8; the decode loops under
    `set_sync_debug_mode("error")` (`sync_free`).  `fed`: an earlier run's
    tokens, fed in its order (else greedy).  Returns the logits, tokens,
    launches, steady walls (replays only on a graphed engine), host time
    of one step, device bytes allocated over the run after `finish`, what
    the live keys hold then, and the bytes after `close`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serverless.gateway import greedy, settle, sync_free
    from repro_torch.serving.engine import _paged_decode_step

    m, dev, g = cfg.name, eng.device, eng.step_graphs
    B = len(PROMPT_LENS)
    feed = iter(fed) if fed is not None else None
    out = {"logits": [], "tokens": [], "walls": {}, "graphs": []}

    def fed_or_greedy(logits):
        # a fed token is copied, so both runs allocate what they hold
        tok = next(feed).clone() if feed is not None else greedy(logits)
        out["tokens"].append(tok)
        return tok

    def steps(n, step):
        for _ in range(n):
            logits = step()
            out["logits"].append(logits)
            step.tok = fed_or_greedy(logits)

    def timed(name, n, step):
        settle(step.tok)
        t0 = time.perf_counter()
        with sync_free(dev):
            steps(n, step)
        settle(step.tok)
        out["walls"][name] = (time.perf_counter() - t0) / n * 1e3

    def mark(what):
        if g is not None:
            out["graphs"].append((what, g.captures, len(g.live(m))))

    ops.reset_launch_counts()
    base = allocated(dev)
    inst = eng.start_instance(m, max_blocks_per_seq=64, num_pages=256)

    def one():
        return inst.decode(one.tok)

    one.tok = fed_or_greedy(inst.prefill(batch, lengths=PROMPT_LENS))
    mark("before the window")
    with sync_free(dev):  # the first call, the capture and replays
        steps(GRAPH_EVICT_AT - 1, one)
    mark("after the window")
    settle(one.tok)
    eng.drop_device_copies(m)
    mark("evicted")
    eng.load(m)
    steps(2, one)  # eager again, then a recapture
    mark("recaptured")
    timed("B 4", GRAPH_STEPS - GRAPH_EVICT_AT - 1, one)
    inst2 = eng.start_instance(m, max_blocks_per_seq=64, num_pages=256)
    tok2 = fed_or_greedy(inst2.prefill(batch, lengths=PROMPT_LENS[::-1]))

    def fused():
        a, b = eng.decode_many([(inst, fused.tok[:B]), (inst2, fused.tok[B:])])
        return torch.cat([a, b])

    fused.tok = torch.cat([one.tok, tok2])
    steps(2, fused)
    timed("decode_many B 8", GRAPH_STEPS - 2, fused)
    mark("fused")
    out["launches"] = ops.launch_counts()
    # host time of one step alone at B 4 (its key is live on a graphed
    # engine; the writes land at the instance's next position, rewritten by
    # its next step)
    params = eng.params_of(m)
    args = (params, cfg, one.tok, inst._tables, inst._lengths)
    out["host_us"] = math.nan  # a host time of CPU kernels says nothing of the card's
    if g is None and dev.type == "cuda":
        out["host_us"] = _host_us(lambda: _paged_decode_step(
            *args, inst.slab.pages), calls=4, repeats=3)
    elif g is not None:
        out["pool_bytes"] = g.pool_bytes()
        if dev.type == "cuda":
            replays = g.replays
            out["host_us"] = _host_us(lambda: eng._paged_step(m, params, cfg, inst.slab,
                                                              *args[2:], "kernel"), calls=50)
            assert g.replays == replays + 250, (g.replays, replays)  # 5 x 50, all replays
    inst.finish()
    inst2.finish()
    out["allocated"] = allocated(dev) - base
    mark("finished")
    if g is not None:  # what the keys that outlive the instances hold
        out["live"], out["held"], out["budget"] = live_bytes(g), g.held_bytes(), g.budget
    eng.close()
    out["closed"] = allocated(dev) - base
    return out


def graphs_phase(cfg, weights, device="cuda") -> dict:
    """`[graphs]`: llama3.2-1b at full width on two engines over the same
    weights, one eager (``cuda_graphs=False``) and one graphed (the
    default): `graph_run` on each, the graphed run fed the eager run's
    tokens; logits equal step by step (bitwise, else within the bf16
    tolerance with greedy ties), launches equal, a capture inside the
    sync-error window, the graph dropped at the eviction and recaptured
    after, the recaptured and the fused keys live after `finish`, device
    memory then the eager engine's plus those keys' tensors (within the
    budget), and the eager engine's after `close`; capture time, pool
    bytes, host time of a step; then `[profile]` of both."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine

    dev, m = torch.device(device), cfg.name
    cuda = dev.type == "cuda"
    size = model_sizes({m: cfg})[m]
    B, S = len(PROMPT_LENS), max(PROMPT_LENS)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(7),
                                        ShapeConfig("graphs", S, B, "prefill"), device=dev)
    runs = {}
    for route in ("eager", "graphed"):
        eng = Engine(size + 4 * KV_ROOM, device=dev, engine_id=route,
                     cuda_graphs=route == "graphed")
        eng.register(m, cfg, init_fn=lambda: weights)
        eng.load(m)
        if route == "graphed" and cuda:
            assert eng.step_graphs is not None
        fed = runs["eager"]["tokens"] if route == "graphed" else None
        runs[route] = run = graph_run(eng, cfg, batch, fed)
        run["engine"] = eng
        log(f"[graphs] {route}: decode {run['walls']['B 4']:.3f} ms/step at B 4, "
            f"decode_many {run['walls']['decode_many B 8']:.3f} ms/step at B 8 (replays only "
            f"when graphed); host time of one B 4 step {run['host_us']:.2f} us; launches "
            f"{json.dumps(run['launches'])}; device bytes allocated over the run after "
            f"finish {run['allocated']}")
    eager, graphed = runs["eager"], runs["graphed"]
    L = cfg.num_layers
    dispatches = 2 * GRAPH_STEPS
    assert graphed["launches"] == eager["launches"], (graphed["launches"], eager["launches"])
    if cuda:
        assert eager["launches"] == {"paged_attention": L * dispatches,
                                     "flash_attention": 2 * L, "moe_experts": 0,
                                     "rope_kv_write": L * dispatches,
                                     "add_rms_norm": (2 * L + 1) * dispatches}, eager["launches"]
    bitwise, worst, flips = 0, 0.0, 0
    for i, (e, gr) in enumerate(zip(eager["logits"], graphed["logits"])):
        assert e.shape == gr.shape and bool(torch.isfinite(gr.float()).all()), i
        if torch.equal(e, gr):
            bitwise += 1
            continue
        err, scale = rel_err(gr, e), max(1.0, float(e.float().abs().max()))
        worst = max(worst, err)
        assert err <= TOL["bfloat16"], f"step {i}: graphed logits differ by {err} of scale"
        et, gt = e.float().argmax(-1), gr.float().argmax(-1)
        for b in torch.nonzero(et != gt).flatten().tolist():
            gap = float(e[b, et[b]].float() - e[b, gt[b]].float())
            assert gap <= TOL["bfloat16"] * scale, f"step {i} seq {b}: gap {gap}"
            flips += 1
    log(f"[graphs] graphed vs eager logits over {len(eager['logits'])} steps (B 4 then "
        f"fused B 8): {bitwise} bitwise equal; the rest within {worst:.3e} of scale (tol "
        f"{TOL['bfloat16']:g}), {flips} greedy ties")
    g = graphed["engine"].step_graphs
    if g is not None:
        marks = dict((what, (caps, live)) for what, caps, live in graphed["graphs"])
        log(f"[graphs] captures and live graphs: {json.dumps(marks)}; {graph_stats(g)}; "
            f"live pools before finish {graphed['pool_bytes']} B")
        assert marks["before the window"] == (0, 0), marks
        assert marks["after the window"] == (1, 1), marks  # captured under "error"
        assert marks["evicted"] == (1, 0), marks
        assert marks["recaptured"] == (2, 1), marks
        # the recaptured B 4 key and the fused B 8 key outlive the instances
        assert marks["fused"] == (3, 2) and marks["finished"] == (3, 2), marks
    if cuda:
        assert graphed["allocated"] == eager["allocated"] + graphed["live"], (
            graphed["allocated"], eager["allocated"], graphed["live"])
        assert 0 < graphed["live"] <= graphed["held"] <= graphed["budget"], graphed["held"]
        assert graphed["closed"] == eager["closed"] == eager["allocated"], (
            graphed["closed"], eager["closed"])
        before = torch.cuda.memory_reserved(dev)
        torch.cuda.empty_cache()
        log(f"[graphs] after finish the graphed engine holds {graphed['allocated']} B more "
            f"than before its run: the eager engine's {eager['allocated']} B and its 2 live "
            f"keys' {graphed['live']} B requested ({graphed['held']} B held: private pools "
            f"reserved and static inputs, of a {graphed['budget']} B budget); after close "
            f"{graphed['closed']} B, as the eager engine ({eager['closed']} B); reserved "
            f"{before} B, {torch.cuda.memory_reserved(dev)} B after empty_cache")
        for route in ("eager", "graphed"):
            profile_decode(runs[route]["engine"], cfg, batch)
    for run in runs.values():
        run["engine"].close()
    return {route: {k: run[k] for k in ("walls", "host_us", "launches", "allocated")}
            for route, run in runs.items()}


# --------------------------------------------------------------- [examples]
EXAMPLE_CKPT = ROOT / "build" / "examples_ckpt"
EXAMPLES = {  # module -> a line its own check prints
    "quickstart": "transferred 0.0 MB, reuse=100%",
    "serve_engine": "reload: 100% reused, 0 bytes transferred",
    "serve_cluster": "tangram-conc",
    "train_100m": "restored step",
}


def examples_phase(device="cuda", overrides=None):
    """`[examples]`: the four ported examples (`python -m
    repro_torch.examples.<name>`) at the reference's sizes, started together
    on `device`; each must exit 0 and print its own check's line (quickstart:
    the warm reload moves 0 bytes; serve_engine: the paged decode against
    the dense path, then a 100% reload; serve_cluster: the policy table;
    train_100m: 300 steps, a crash at 150 and the restore, its last loss
    below its first).  `overrides` gives an example other arguments (a
    train_100m cut short keeps its restore check, not the loss's fall)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    args = {"train_100m": ("--ckpt-dir", str(EXAMPLE_CKPT)), **(overrides or {})}
    for name in EXAMPLES:
        argv = [sys.executable, "-m", f"repro_torch.examples.{name}", *args.get(name, ()),
                "--device", device]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = {}
    for name, (t0, proc) in procs.items():
        text, _ = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        lines = text.splitlines()
        for line in lines[-4:]:
            log(f"[examples] {name}: {line}")
        log(f"[examples] {name} exited {proc.returncode} after {wall:.1f} s")
        assert proc.returncode == 0, (name, text[-3000:])
        assert any(EXAMPLES[name] in line for line in lines), (name, EXAMPLES[name])
        outs[name] = lines
    losses = [float(line.rsplit("loss", 1)[1]) for line in outs["train_100m"]
              if line.startswith("[run")]
    log(f"[examples] train_100m loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
        f"{len(losses)} printed steps")
    if "train_100m" not in (overrides or {}):  # its 300 steps, past the warmup
        assert losses[-1] < losses[0], losses
    paged = next(line for line in outs["serve_engine"] if line.startswith("paged vs dense"))
    log(f"[examples] serve_engine {paged}")
    import shutil

    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)


def state_configs() -> dict:
    """The non-paged families at full width, mixtral-8x7b with 6 of its 32
    layers, in the trace's model order."""
    import dataclasses

    from repro_torch.configs import get_config

    cfgs = {m: get_config(m) for m in STATE_MODELS}
    cfgs["mixtral-8x7b"] = dataclasses.replace(cfgs["mixtral-8x7b"],
                                               num_layers=STATE_MIXTRAL_LAYERS)
    return cfgs


@contextlib.contextmanager
def eager_steps(eng):
    """`eng`'s decode steps eager inside the block, as ``cuda_graphs=False``
    runs them: a Python hook around a step (`router_choices`) sees only
    eager calls.  Every key is freed on entry, as a drop site frees it: the
    drop sites skip an engine without graphs, so none may be live inside."""
    graphs = eng.step_graphs
    if graphs is not None:
        graphs.drop()
    eng.step_graphs = None
    try:
        yield
    finally:
        eng.step_graphs = graphs


def logits_match(tag, what, got, want) -> str:
    """`got` against `want`, row by row: bitwise, else within the bf16
    tolerance of scale; returns the count line."""
    import torch

    bitwise, worst = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all()), (what, i)
        if torch.equal(g, w):
            bitwise += 1
            continue
        worst = max(worst, rel_err(g, w))
        assert worst <= TOL["bfloat16"], f"{tag} {what} row {i}: {worst} of scale"
    return (f"{bitwise} of {len(want)} bitwise equal, the rest within {worst:.3e} of scale "
            f"(tol {TOL['bfloat16']:g})")


def long_prompt_probe(eng, m: str, S: int, steps: int = SERVERLESS_GEN) -> dict:
    """One prompt of S tokens (longer than the model's window) straight
    through `Engine` at B 1, then `steps` greedy tokens: the prefill's K2
    launches counted, the decode sync-free over a window-sized ring; every
    logit row held against the plain attention path fed the same tokens
    (a MoE model's plain run takes the kernel path's expert choices), both
    on the eager step, so the router hook sees every step; then the graphed
    step fed the same tokens, held against the eager kernel run.  Returns
    the kernel path's launch counts."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import build_model
    from repro_torch.serverless.gateway import greedy, settle, sync_free

    cfg = eng.models[m].cfg
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(S),
                                        ShapeConfig("long", S, 1, "prefill"),
                                        device=eng.device)

    def run(plain, fed=None):
        eng.load(m)  # its instance's finish releases it
        inst = eng.start_instance(m)
        kernel = ops.flash_attention
        if plain:
            ops.flash_attention = flash_attention_ref
        try:
            t0 = time.perf_counter()
            outs = [inst.prefill(batch)]
            tok = settle(greedy(outs[0]))
            prefill_s = time.perf_counter() - t0
        finally:
            ops.flash_attention = kernel
        feeding = fed is not None
        fed = fed if feeding else []
        t0 = time.perf_counter()
        with sync_free(eng.device):
            for i in range(steps):
                if feeding:  # the eager kernel path's tokens
                    tok = fed[i]
                else:
                    fed.append(tok)
                outs.append(inst.decode(tok))
                tok = greedy(outs[-1])
        settle(tok)
        decode_s = time.perf_counter() - t0
        ring = ring_slots(inst)
        inst.finish()
        return outs, fed, ring, prefill_s, decode_s

    route = []
    record = router_choices(record=route) if cfg.is_moe else contextlib.nullcontext()
    replay = router_choices(replay=route) if cfg.is_moe else contextlib.nullcontext()
    with eager_steps(eng):
        ops.reset_launch_counts()
        with record:
            outs, fed, ring, prefill_s, decode_s = run(False)
        counts = ops.launch_counts()
        with replay:
            plain, _, _, _, _ = run(True, fed)
    replays = eng.step_graphs.replays if eng.step_graphs is not None else 0
    graphed, _, _, _, graphed_s = run(False, fed)
    if eng.step_graphs is not None:  # the first step eager, the second the capture
        assert eng.step_graphs.replays - replays == steps - 1, (eng.step_graphs.replays,
                                                                replays)
    worst = max(rel_err(a, b) for a, b in zip(outs, plain))
    window = cfg.sliding_window
    log(f"[state-families] {m} long probe: prompt {S} > window {window}, decode over a "
        f"{ring}-slot ring; prefill {prefill_s * 1e3:.3f} ms, decode "
        f"{decode_s / steps * 1e3:.3f} ms/token eager, {graphed_s / steps * 1e3:.3f} graphed "
        f"(B 1, sync-free; the graphed run's first step eager, its second the capture); "
        f"launches {json.dumps(counts)}; {len(outs)} logit rows vs the plain attention path "
        f"(both eager): max |diff| / scale {worst:.3e} (tol {TOL['bfloat16']:g}); graphed vs "
        f"eager: {logits_match('long probe', m, graphed, outs)}")
    assert ring == min(window, -(-S // eng.block_tokens) * eng.block_tokens) == window
    assert worst <= TOL["bfloat16"], (m, worst)
    want = kernel_launches(cfg, 1, steps)
    if eng.device.type == "cuda":
        assert counts == want, (counts, want)
    return counts


def recurrence_timing(cfgs: dict):
    """Device time of the plain-PyTorch recurrences the prefill runs where
    the reference has no kernel either: the RG-LRU linear scan
    (recurrentgemma-9b, B 1, width 4096, fp32) and the chunked SSD scan
    (mamba2-2.7b, B 1, 80 heads of 64, state 128, chunk 256), per layer and
    per prefill of the phase's prompt."""
    import torch

    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(0)
    rg, mb = cfgs["recurrentgemma-9b"], cfgs["mamba2-2.7b"]
    n_rg = sum(k == "rglru" for k in rg.pattern)
    for S in (STATE_PROMPT, STATE_LONG["recurrentgemma-9b"]):
        a = torch.rand((1, S, rg.lru_width), generator=gen, device="cuda") * 0.1 + 0.9
        b = torch.randn((1, S, rg.lru_width), generator=gen, device="cuda")
        # ~110-150 launches a call: few iterations, so the device spin ahead
        # of the timed window outlasts their enqueue
        ms = cuda_time_ms(lambda: layers.linear_scan(a, b), iters=5)
        log(f"[timing] rglru linear_scan B1 S{S} W{rg.lru_width} fp32: {ms:.4f} ms a layer, "
            f"{ms * n_rg:.3f} ms for the {n_rg} RG-LRU layers of a prefill")
    _, H, N, _ = layers._ssd_dims(mb)
    S, P = STATE_PROMPT, mb.ssm_head_dim
    x = torch.randn((1, S, H, P), generator=gen, device="cuda").to(mb.torch_dtype)
    A = -torch.rand((1, S, H), generator=gen, device="cuda") * 0.1
    Bm = torch.randn((1, S, N), generator=gen, device="cuda").to(mb.torch_dtype)
    Cm = torch.randn((1, S, N), generator=gen, device="cuda").to(mb.torch_dtype)
    ms = cuda_time_ms(lambda: layers.ssd_chunked(x, A, Bm, Cm, mb.ssm_chunk), iters=5)
    log(f"[timing] ssd_chunked B1 S{S} H{H} P{P} N{N} chunk {mb.ssm_chunk}: {ms:.4f} ms a "
        f"layer, {ms * mb.num_layers:.3f} ms for the {mb.num_layers} SSD layers of a prefill")


STATE_GRAPH_STEPS = 16  # decode steps of the eager-against-graphed check
STATE_GRAPH_WARM = 2  # untimed: on a graphed engine the key's eager first call and its capture
STATE_GRAPH_PROFILED = 4  # steps under the profiler, whose event processing costs seconds


def state_graph_run(cfg, weights, dev, graphed: bool, fed=None) -> dict:
    """One model on its own engine (eager, or graphed: the default), over
    the page-locked `weights`: a B 1 prefill of the phase's prompt, then
    `STATE_GRAPH_STEPS` decode steps sync-free, the last ones timed, then
    `STATE_GRAPH_PROFILED` more under the profiler.  `fed`: an earlier
    run's tokens (else greedy).  Returns the logits, tokens, steady wall,
    profile, requested device bytes after `finish` and after `close`, what
    the live key holds after `finish`, an eager step's peak growth and the
    graphs' costs."""
    import torch

    from repro_torch.serverless.gateway import greedy, make_prefill_batch, settle, sync_free
    from repro_torch.serving.engine import Engine

    m = cfg.name
    eng = Engine(model_sizes({m: cfg})[m] + KV_ROOM, device=dev, cuda_graphs=graphed,
                 engine_id="graphed" if graphed else "eager")
    eng.register(m, cfg, init_fn=lambda: weights)
    eng.load(m)
    g = eng.step_graphs
    batch = make_prefill_batch(eng, m, STATE_PROMPT, 0)
    feed = iter(fed) if fed is not None else None
    out = {"logits": [], "tokens": [], "peak_step": 0}

    def take(logits):
        out["logits"].append(logits)
        # a fed token is copied, so both runs allocate what they hold
        tok = next(feed).clone() if feed is not None else greedy(logits)
        out["tokens"].append(tok)
        return tok

    base = allocated(dev)
    inst = eng.start_instance(m)
    tok = settle(take(inst.prefill(batch)))
    with sync_free(dev):
        if dev.type == "cuda" and g is None:  # what one eager step allocates at its peak
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            tok = take(inst.decode(tok))
            out["peak_step"] = torch.cuda.max_memory_allocated(dev) - before
        while len(out["logits"]) <= STATE_GRAPH_WARM:
            tok = take(inst.decode(tok))
    settle(tok)
    t0 = time.perf_counter()
    with sync_free(dev):
        for _ in range(STATE_GRAPH_STEPS - STATE_GRAPH_WARM):
            tok = take(inst.decode(tok))
    settle(tok)
    out["wall_ms"] = (time.perf_counter() - t0) / (STATE_GRAPH_STEPS - STATE_GRAPH_WARM) * 1e3
    out["profile"] = {}
    if dev.type == "cuda":
        out["profile"] = profile_decode_steps(inst, tok, STATE_GRAPH_PROFILED,
                                              "state-families", f"{m} B=1 {eng.engine_id}")
    if g is not None:
        out["graphs"] = [(x.capture_seconds * 1e3, x.pool_bytes,
                          sum(t.nbytes for t in x.inputs)
                          + sum(t.nbytes for t, j in zip(x.outputs, x.passed) if j is None))
                         for x in g.live(m)]
    inst.finish()
    out["allocated"] = allocated(dev) - base
    if g is not None:  # the key outlives the instance
        out["live"], out["held"], out["budget"] = live_bytes(g), g.held_bytes(), g.budget
    eng.close()
    out["closed"] = allocated(dev) - base
    return out


def state_graphs_check(cfgs: dict, weights: dict, device="cuda"):
    """Each non-paged model at full width on an eager engine and a graphed
    one over the same weights (`state_graph_run`), the graphed run fed the
    eager run's tokens: decode logits equal (bitwise, else within the bf16
    tolerance), requested device bytes after `finish` the eager engine's
    plus the live key's tensors (within the budget), and equal after
    `close`; steady walls,
    profiles and each graph's capture time, private pool and bytes a replay
    copies (in, and out again) logged."""
    import torch

    dev = torch.device(device)
    for m, cfg in cfgs.items():
        eager = state_graph_run(cfg, weights[m], dev, False)
        graphed = state_graph_run(cfg, weights[m], dev, True, eager["tokens"])
        match = logits_match("state-families", m, graphed["logits"], eager["logits"])
        log(f"[state-families] {m} eager vs graphed, B 1, prompt {STATE_PROMPT}, "
            f"{STATE_GRAPH_STEPS} steps: logits {match}; steady decode {eager['wall_ms']:.3f} "
            f"ms/token eager, {graphed['wall_ms']:.3f} graphed ("
            f"{graphed['wall_ms'] / eager['wall_ms']:.3f} of eager) over the last "
            f"{STATE_GRAPH_STEPS - STATE_GRAPH_WARM} steps; requested device bytes after "
            f"finish {eager['allocated']} eager, {graphed['allocated']} graphed (its live "
            f"key's {graphed.get('live', 0)} B; {graphed.get('held', 0)} B held), after close "
            f"{eager['closed']} eager, {graphed['closed']} graphed")
        if dev.type != "cuda":
            continue
        for ms, pool, copied in graphed["graphs"]:
            log(f"[state-families] {m} graph: capture {ms:.3f} ms, private pool {pool} B "
                f"(an eager step's peak growth {eager['peak_step']} B), {copied} B copied a "
                f"replay (inputs in, outputs out)")
        e, gr = eager["profile"], graphed["profile"]
        if e and gr:
            # the profiler's own tracing lengthens a profiled wall: the idle
            # share is also read against the unprofiled steady wall
            unprofiled = [1 - r["profile"]["busy_ms"] / r["wall_ms"] for r in (eager, graphed)]
            log(f"[state-families] {m} profiled step eager / graphed: wall {e['wall_ms']:.3f} "
                f"/ {gr['wall_ms']:.3f} ms, busy {e['busy_ms']:.3f} / {gr['busy_ms']:.3f} ms, "
                f"idle {e['idle']:.3f} / {gr['idle']:.3f} ({unprofiled[0]:.3f} / "
                f"{unprofiled[1]:.3f} against the unprofiled walls), kernels "
                f"{e['kernels']:.0f} / {gr['kernels']:.0f}, device copies {e['copy_ms']:.3f} / "
                f"{gr['copy_ms']:.3f} ms")
        assert len(graphed["graphs"]) == 1, graphed["graphs"]
        assert graphed["allocated"] == eager["allocated"] + graphed["live"], (
            graphed["allocated"], eager["allocated"], graphed["live"])
        assert 0 < graphed["live"] <= graphed["held"] <= graphed["budget"], graphed["held"]
        assert graphed["closed"] == eager["closed"] == eager["allocated"], (
            graphed["closed"], eager["closed"])


# the gateway engine's replays against its prefetch worker: mamba2-2.7b's B 1
# replays with the worker idle, then while it promotes the smallest leaves the
# other models hold in no device buffer (at least PREFETCH_PROBE_BYTES,
# spilled to the persistent store first) back into the host tier
PREFETCH_PROBE = "mamba2-2.7b"
PREFETCH_PROBE_BYTES = 1 << 30


def prefetch_probe(eng, steps: int = STEADY_STEPS):
    """Where the gateway engine's state-family replays idle: `steps` timed
    B 1 replays of `PREFETCH_PROBE` and 8 profiled (CUDA), first with the
    prefetch worker idle, then with it promoting other models' spilled
    leaves (store read, checksum, page-locked copy on the worker thread);
    logs each wall, the device busy time and idle share, and the bytes the
    worker promoted meanwhile.  A finding only: no prefetch code changes."""
    from repro_torch.serverless.gateway import greedy, make_prefill_batch, settle

    m = PREFETCH_PROBE
    eng.load(m)
    inst = eng.start_instance(m)
    tok = settle(greedy(inst.prefill(make_prefill_batch(eng, m, STATE_PROMPT, 0))))
    tok, live = warm_steps(inst, tok)
    lines = []
    for worker in ("idle", "busy"):
        jobs, promoted = {}, eng.prefetcher.bytes_promoted
        if worker == "busy":
            spilled = 0
            with eng._store_lock:  # a device hit is never promoted: spill misses only
                misses = sorted(((r.nbytes, r.fingerprint, mid) for mid, reg in eng.models.items()
                                 if mid != m for r in reg.records
                                 if r.fingerprint not in eng._tensors))
                for nbytes, fp, mid in misses:
                    if spilled >= PREFETCH_PROBE_BYTES:
                        break
                    if eng.host_store.evict(fp):
                        spilled += nbytes
                        jobs[mid] = None
            jobs = {mid: eng.prefetch(mid) for mid in jobs}
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = greedy(inst.decode(tok))
        settle(tok)
        wall = (time.perf_counter() - t0) / steps * 1e3
        during = eng.prefetcher.bytes_promoted - promoted
        line = (f"worker {worker}: {wall:.3f} ms/token over {steps} replays, "
                f"{during} B promoted meanwhile")
        if eng.device.type == "cuda":
            prof = profile_decode_steps(inst, tok, 8, "state-families",
                                        f"{m} B=1 on the gateway engine, prefetch worker {worker}")
            if prof:
                line += (f", device busy {prof['busy_ms']:.3f} ms: idle share "
                         f"{1 - prof['busy_ms'] / wall:.3f} of the unprofiled wall")
        if jobs:
            line += (f", {sum(not j.done.is_set() for j in jobs.values())} of {len(jobs)} jobs "
                     f"({', '.join(jobs)}) still promoting after the profile ({spilled} B "
                     f"spilled)")
            for mid in jobs:
                eng.cancel_prefetch(mid)
            assert eng.prefetcher.bytes_promoted > promoted, "the worker promoted nothing"
        lines.append(line)
    inst.finish()
    eng.release(m)
    log(f"[state-families] prefetch probe, {m} B 1 replays on the gateway engine (key "
        f"{'live' if live else 'fresh'} at its first step): " + "; ".join(lines))


def state_families_phase(cfgs: dict, weights: dict, device="cuda") -> dict:
    """`[state-families]`: the `Gateway` over the non-paged families, then a
    long-prompt probe per SWA model on the same engine, then each model on
    an eager and a graphed engine (`state_graphs_check`)."""
    from repro_torch.configs import get_config

    sizes = model_sizes(cfgs)
    whole = model_sizes({"mixtral-8x7b": get_config("mixtral-8x7b")})["mixtral-8x7b"]
    log(f"[state-families] mixtral-8x7b cut to {cfgs['mixtral-8x7b'].num_layers} of "
        f"{get_config('mixtral-8x7b').num_layers} layers: {sizes['mixtral-8x7b']} of "
        f"{whole} B (widths, 8 experts top-2 and the 4096 window kept)")
    pool = sizes["mixtral-8x7b"] + sizes["recurrentgemma-9b"] // 2

    def probes(eng):
        counts = {f"{m} long": long_prompt_probe(eng, m, S) for m, S in STATE_LONG.items()}
        if eng.device.type == "cuda":
            profile_states(eng, list(cfgs))
        prefetch_probe(eng)
        return counts

    counts = serverless_phase(cfgs, weights, device, tag="state-families",
                              trace_kw=STATE_TRACE, prompt=STATE_PROMPT, pool=pool,
                              probe=probes)
    state_graphs_check(cfgs, weights, device)
    return counts


def host_tree(eng, m):
    """Model `m`'s parameter tree over the engine's host-tier tensors."""
    from repro_torch.models.tensors import tree_unflatten

    reg = eng.models[m]
    return tree_unflatten(reg.treedef, [eng.host_store.get(r.fingerprint) for r in reg.records])


def dedup_phase(cfg, weights, device="cuda") -> dict:
    """`[dedup]`: fine-tune variants of one base share its device tensors.

    With the base resident, each variant's cold load moves exactly its delta
    leaves over h2d (the default `register_variant` perturbation), its
    shared leaves are the base's device storage, its first-token logits
    hold against the plain attention path and differ from the base's.  Then
    a pool of the base, one delta and one request's KV serves the variants
    again: the pool evicts deltas, never a leaf an active sharer reads, and
    each variant gives the same logits as before."""
    import torch

    from repro_torch.models.tensors import VariantSpec, flatten_params, spec_records
    from repro_torch.serverless.gateway import greedy, make_prefill_batch
    from repro_torch.serving.engine import Engine

    dev = torch.device(device)
    base = cfg.name
    base_recs = spec_records(base, cfg)
    size = sum(r.nbytes for r in base_recs)
    vspecs = [VariantSpec(f"{base}-ft{i}", base, DEDUP_DELTAS) for i in range(DEDUP_VARIANTS)]
    variants = [vs.variant_id for vs in vspecs]
    base_fps = {r.fingerprint for r in base_recs}
    delta = sum(r.nbytes for r in spec_records(vspecs[0].to_model_spec(), cfg)
                if r.fingerprint not in base_fps)
    pool = size + DEDUP_VARIANTS * delta + KV_ROOM
    eng = Engine(pool, device=dev, engine_id="dedup")
    eng.register(base, cfg, init_fn=lambda: weights)
    for vs in vspecs:
        eng.register_variant(vs)
    log(f"[dedup] base {base} {size} B; {DEDUP_VARIANTS} variants, delta leaves "
        f"{list(DEDUP_DELTAS)} ({delta} B); pool {pool} B")
    batch = make_prefill_batch(eng, base, SERVERLESS_PROMPT, 0)
    eng.load(base)
    eng.retain(base)  # resident and in use while the variants load
    base_leaves = dict(flatten_params(eng.params_of(base)))
    inst = eng.start_instance(base)
    token = greedy(inst.prefill(batch))  # fed to every model's first decode
    inst.finish()
    logits = {base: first_logits(eng, base, batch, token)}
    for v in variants:
        t0 = time.perf_counter()
        rep = eng.load(v)
        load_s = time.perf_counter() - t0
        st = eng.last_load
        log(f"[dedup] {v} cold load {load_s * 1e3:.3f} ms (init {st.init_seconds * 1e3:.3f} ms, "
            f"h2d {st.transfer_seconds * 1e3:.3f} ms): bytes h2d {st.bytes_h2d}, device-hit "
            f"{st.bytes_device_hit}, materialized leaves {st.leaves_materialized}, reuse "
            f"{rep.reuse_fraction:.4f}")
        assert st.bytes_h2d == delta == rep.bytes_transferred, (st.as_dict(), delta)
        assert st.bytes_device_hit == size - delta
        check_sharing(eng, v, base_leaves)
        logits[v] = first_logits(eng, v, batch, token)
        plain = first_logits(eng, v, batch, token, plain=True)
        errs = {step: rel_err(logits[v][step], plain[step]) for step in plain}
        apart = {step: rel_err(logits[v][step], logits[base][step]) for step in plain}
        log(f"[dedup] {v} first logits vs the plain path {errs} (tol {TOL['bfloat16']:g}); "
            f"vs the base {apart}")
        assert all(e <= TOL["bfloat16"] for e in errs.values()), errs
        assert all(e > TOL["bfloat16"] for e in apart.values()), apart
        eng.release(v)
    dedup = eng.store.dedup_stats().as_dict()
    log(f"[dedup] pool ledger {json.dumps(dedup)}; {host_memory()}")
    assert dedup["sharer_orphans"] == 0

    # the same models on a pool of the base, one delta and one request's KV
    small = size + delta + KV_ROOM
    eng2 = Engine(small, device=dev, engine_id="dedup-small")
    eng2.register(base, cfg, init_fn=lambda: weights)
    for v in variants:
        eng2.register_variant(VariantSpec(v, base, DEDUP_DELTAS),
                              init_fn=lambda t=host_tree(eng, v): t)
    eng.close()
    del eng, base_leaves
    gc.collect()
    eng2.load(base)
    eng2.retain(base)
    base_leaves = dict(flatten_params(eng2.params_of(base)))
    served, reloaded = [], 0
    for v in variants + variants[:1]:  # the last load finds its delta evicted
        missing = sum(r.nbytes for r in eng2.records_of(v) if r.fingerprint not in eng2._tensors)
        rep = eng2.load(v)
        st = eng2.last_load
        assert st.bytes_h2d == missing == rep.bytes_transferred, (v, st.bytes_h2d, missing)
        reloaded += missing if v in served else 0
        check_sharing(eng2, v, base_leaves)
        again = first_logits(eng2, v, batch, token)
        same = all(torch.equal(again[k], logits[v][k]) for k in again)
        err = max(rel_err(again[k], logits[v][k]) for k in again)
        assert err <= TOL["bfloat16"], (v, err)
        eng2.release(v)
        served.append(v)
        evicted = [w for w in served if any(r.fingerprint not in eng2._tensors
                                            for r in eng2.records_of(w))]
        log(f"[dedup] pool {small} B: {v} bytes h2d {st.bytes_h2d}, reuse "
            f"{rep.reuse_fraction:.4f}; logits as on the large pool "
            f"({'bit for bit' if same else f'{err:.3e} of scale'}); variants whose delta "
            f"left the card: {evicted}")
    assert reloaded > 0, "the small pool never evicted a delta"
    assert eng2.store.dedup_stats().sharer_orphans == 0
    eng2.close()
    del eng2
    gc.collect()
    return {"delta_bytes": delta}


def check_sharing(eng, v, base_leaves):
    """Variant `v`'s shared leaves are the base's device tensors (same
    storage); its delta leaves are its own and differ from the base's; every
    leaf of a model in use is on the card."""
    import torch

    from repro_torch.models.tensors import flatten_params

    spec = eng.models[v].spec
    for name, leaf in flatten_params(eng.params_of(v)):
        b = base_leaves[name]
        if spec.is_delta(name):
            assert leaf.data_ptr() != b.data_ptr() and not torch.equal(leaf, b), name
        else:
            assert leaf.data_ptr() == b.data_ptr(), name
    for m in eng.store.active_models:
        assert all(r.fingerprint in eng._tensors for r in eng.records_of(m)), m


def migration_phase(cfg, weights, device="cuda") -> dict:
    """`[migration]`: a live decode handed from one `Engine` to another on the
    card (`migrate_out` -> `migrate_in`), whose replayed window must equal
    the source's logits bit for bit."""
    import torch

    from repro_torch.serverless.gateway import greedy, make_prefill_batch, settle, sync_free
    from repro_torch.serving.engine import Engine

    dev = torch.device(device)
    m = cfg.name
    size = model_sizes({m: cfg})[m]
    src, dst = (Engine(size + KV_ROOM, device=dev, engine_id=e) for e in ("src", "dst"))
    for e in (src, dst):
        e.register(m, cfg, init_fn=lambda: weights)
        e.load(m)
    inst = src.start_instance(m)
    tok = settle(greedy(inst.prefill(make_prefill_batch(src, m, SERVERLESS_PROMPT, 0))))
    with sync_free(dev):
        for _ in range(MIGRATE_BEFORE):
            tok = greedy(inst.decode(tok))
    settle(tok)
    t0 = time.perf_counter()
    mig = src.migrate_out(m, "seq0")
    d2h_s = time.perf_counter() - t0
    window = []
    for _ in range(MIGRATE_WINDOW):
        mig.replay.append(int(tok[0]))
        logits = inst.decode(tok)
        window.append(logits.clone())
        tok = greedy(logits)
    walls = {}
    transfer = dst._xfer.transfer

    def timed(items, stats=None):
        t = time.perf_counter()
        out = transfer(items, stats)
        walls["h2d"] = time.perf_counter() - t
        walls["h2d_end"] = time.perf_counter()
        return out

    dst._xfer.transfer = timed
    try:
        inst2, replayed = dst.migrate_in(mig)
        settle(replayed[-1])
    finally:
        dst._xfer.transfer = transfer
    replay_s = time.perf_counter() - walls["h2d_end"]
    equal = [torch.equal(a, b) for a, b in zip(replayed, window)]
    log(f"[migration] {m}: snapshot of {mig.snap.num_blocks} pages ({mig.nbytes()} B, K + V) "
        f"at length {mig.snap.seq_len}; d2h snapshot {d2h_s * 1e3:.3f} ms "
        f"({mig.nbytes() / d2h_s / 1e9:.2f} GB/s), h2d restore {walls['h2d'] * 1e3:.3f} ms "
        f"({mig.nbytes() / walls['h2d'] / 1e9:.2f} GB/s), scatter + replay of "
        f"{len(replayed)} tokens {replay_s * 1e3:.3f} ms; replayed logits bit-identical: "
        f"{equal}; counters out {src.migrated_out} / in {dst.migrated_in} / bytes "
        f"{src.migration_bytes}")
    assert len(replayed) == MIGRATE_WINDOW and all(equal), equal
    assert src.migrated_out == dst.migrated_in == 1
    assert src.migration_bytes == mig.nbytes()
    T = src.block_tokens
    blocks = -(-(SERVERLESS_PROMPT + MIGRATE_BEFORE) // T)
    page = T * cfg.num_kv_heads * cfg.resolved_head_dim * window[0].element_size()
    assert mig.snap.num_blocks == blocks
    assert mig.nbytes() == 2 * cfg.num_layers * blocks * page, (mig.nbytes(), blocks)
    inst.finish(), inst2.finish()
    for e in (src, dst):
        e.close()
    return {"bytes": mig.nbytes(), "d2h_s": d2h_s, "h2d_s": walls["h2d"]}


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
    served = {e.engine_id: iter(e.requests) for e in engines}  # each engine's instances
    steps = []
    for d, rec in zip(fg.decisions, sink.records):
        st = next(served[d[2]])
        assert st["model"] == d[1], (d, st)
        steps.append(st)
        log(f"[fleet] t {d[0]:.3f} {d[1]:12s} -> {d[2]} {'cold' if d[3] else 'warm'} queue "
            f"{d[4]:.6f} s; load {rec.load_s * 1e3:.3f} ms, prefill {rec.prefill_s * 1e3:.3f} "
            f"ms, decode {rec.decode_s / SERVERLESS_GEN * 1e3:.3f} ms/token, store bytes "
            f"{rec.bytes_from_store}, prefetched {rec.prefetched}; decode steps: {st['eager']} "
            f"eager, {st['captures']} captures, {st['replays']} replays (key "
            f"{'live' if st['live'] else 'fresh'})")
    assert all(next(it, None) is None for it in served.values())
    check_live_keys("fleet", steps)
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
    n0, k0 = len(eng.loads), len(eng.requests)
    big = max(names, key=sizes.get)
    small = min(names, key=sizes.get)
    t_end = max(trace[-1].time, max(d[0] for d in fg.decisions)) + 100.0
    replay = [Request(t_end + 100.0 * i, m, "gsm8k", SERVERLESS_PROMPT, SERVERLESS_GEN, 1)
              for i, m in enumerate([big, small, big, small])]
    gw = Gateway(eng, keep_alive="zero", prompt_len=SERVERLESS_PROMPT,
                 gen_tokens=SERVERLESS_GEN)
    gw_sink = gw.run_trace(replay)
    steps = eng.requests[k0:]
    assert len(steps) == len(gw_sink.records) == len(eng.loads) - n0
    for i, (rec, load) in enumerate(zip(gw_sink.records, eng.loads[n0:])):
        log(f"[fleet] {crashed} (recovered) "
            + _load_line(i, rec, load, sizes[load[0]], steps[i]))
    check_loads(eng.loads, sizes)
    check_live_keys("fleet", steps)
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


# ------------------------------------------------------------------ phase 11
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS = 12  # the launcher prints steps 0, 10 and 11
TRAIN_LR = 1e-3  # the launcher's default
TRAIN_CHECK_BATCH = 2  # (b): the bf16 step against the fp32 one
TRAIN_REPEAT_STEPS = 20  # (c): one batch, repeated
TRAIN_PROFILE_STEPS = 3
TRAIN_LOSS_MARGIN = 1.0  # (a): |first loss - ln(vocab)| in nats
TRAIN_GRAD_TOL = 5e-2  # relative L2 of a bf16 gradient leaf against its yardstick
TRAIN_LOSS_TOL = 2e-2  # relative, bf16 (tests/test_kernels.py's bf16 tolerance)
TRAIN_REMAT_TOL = 1e-3  # (d): relative, remat on against off (the same ops recomputed)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ = "qwen3-moe-30b-a3b", 4, 512
MOE_TRAIN_STEPS = 3  # of gshard, the launcher's default; then 1 of scatter, 1 of grouped
CKPT_DIR = ROOT / "build" / "train_ckpt"
TRAIN_LAUNCHER_STEPS = 2  # every architecture at --smoke


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_reset(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def logged(tag, fn, *args, **kw):
    """`fn(*args, **kw)` with its standard output logged under `tag`.
    Returns (result, the output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    for line in out.getvalue().splitlines():
        log(f"[{tag}] {line}")
    return result, out.getvalue()


def run_train_main(argv, tag="train"):
    """`repro_torch.launch.train.main(argv)` in this process (`logged`)."""
    from repro_torch.launch import train as launcher

    return logged(tag, launcher.main, argv)


def grad_errors(got, want) -> dict[str, float]:
    """Relative L2 error of each leaf of `got` against `want`."""
    from repro_torch.models.tensors import flatten_params

    out = {}
    for (n, a), (_, b) in zip(flatten_params(got), flatten_params(want)):
        a, b = a.double(), b.double()
        out[n] = float((a - b).norm()) / max(float(b.norm()), 1e-30)
    return out


def hold_grads(tag, what, got, want, loss_got, loss_want, grad_tol=TRAIN_GRAD_TOL,
               loss_tol=TRAIN_LOSS_TOL):
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    rel = abs(loss_got - loss_want) / max(1.0, abs(loss_want))
    log(f"[{tag}] {what}: loss {loss_got:.6f} vs {loss_want:.6f} (rel {rel:.3e}, held "
        f"{loss_tol}), worst leaf {worst} rel L2 {errs[worst]:.3e} (held {grad_tol}) over "
        f"{len(errs)} leaves")
    assert rel <= loss_tol, (what, loss_got, loss_want)
    assert errs[worst] <= grad_tol, (what, worst, errs[worst])


def hold_every_leaf_moves(tag, grads):
    import torch

    from repro_torch.models.tensors import flatten_params

    bad = [n for n, g in flatten_params(grads)
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    assert not bad, f"leaves with a zero or non-finite gradient: {bad}"
    log(f"[{tag}] every leaf's gradient is finite and nonzero")


def train_llama(cfg, device="cuda", smoke=False):
    """llama3.2-1b through the training launcher, then checks (a)-(d), the
    remat run, its peak memory and a profile.  Returns a trained
    {"params", "opt"} tree for the checkpoint round trip."""
    import torch

    from repro_torch.launch.train import loss_and_grads, make_batch, train_step
    from repro_torch.models import build_model, param_count
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
    from repro_torch.train.data import BigramStream, DataConfig
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    dev = torch.device(device)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    argv = ["--arch", TRAIN_ARCH, *(["--smoke"] if smoke else []), "--steps",
            str(TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
            "--lr", str(TRAIN_LR), "--device", device]
    peak_reset(dev)
    t0 = time.perf_counter()
    run, _ = run_train_main(argv)
    launcher_s = time.perf_counter() - t0
    peak_off = peak_bytes(dev)
    n_params = param_count(run.params)
    (s0, loss0, _, w0), (s1, _, _, w1) = run.printed[0], run.printed[-1]
    step_s = (w1 - w0) / (s1 - s0)
    flops = 6 * n_params * tokens
    log(f"[train] {TRAIN_ARCH} B {TRAIN_BATCH} S {TRAIN_SEQ} remat off, through "
        f"launch.train.main: {launcher_s:.3f} s for {TRAIN_STEPS} steps, step wall "
        f"{step_s * 1e3:.3f} ms (steps {s0 + 1}-{s1}), {tokens / step_s:.1f} tokens/s, "
        f"model FLOP/s {flops / step_s / 1e12:.2f} T (6 N tokens, N {n_params}; "
        f"{flops / step_s / PEAK_FLOPS['bfloat16']:.4f} of 989 T), peak memory {peak_off} B")
    ln_v = math.log(cfg.vocab_size)
    log(f"[train] (a) first loss {loss0:.4f}, ln(vocab) {ln_v:.4f}, "
        f"margin held {TRAIN_LOSS_MARGIN}")
    assert math.isfinite(loss0) and abs(loss0 - ln_v) <= TRAIN_LOSS_MARGIN, (loss0, ln_v)
    launcher_losses = {s: loss for s, loss, _, _ in run.printed}
    del run
    release_memory()

    model = build_model(cfg)
    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH))

    def fresh():
        return model.init(torch.Generator(device=dev).manual_seed(0),
                          max_positions=TRAIN_SEQ + 8, device=dev)

    params = fresh()
    batch = make_batch(cfg, data.batch(0, device=dev))
    # (d) remat on and off: one step's loss and gradients, and their peaks
    peaks = {}
    for remat in (False, True):
        peak_reset(dev)
        loss, grads = loss_and_grads(model, params, batch, remat=remat)
        peaks[remat] = peak_bytes(dev)
        if not remat:
            ref_loss, ref_grads = float(loss), grads
        else:
            hold_grads("train", "(d) remat on vs off, one step at B "
                       f"{TRAIN_BATCH}", grads, ref_grads, float(loss), ref_loss,
                       TRAIN_REMAT_TOL, TRAIN_REMAT_TOL)
        del grads
    hold_every_leaf_moves("train", ref_grads)
    log(f"[train] (d) peak memory of one loss and gradient: remat off {peaks[False]} B, "
        f"remat on {peaks[True]} B")
    if dev.type == "cuda":
        assert peaks[True] < peaks[False], peaks
    del ref_grads
    # (b) the bf16 step against the same step with the params cast to fp32
    small = {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()}
    leaves = flatten_params(params)
    p32 = tree_unflatten(tree_structure(params), [t.float() for _, t in leaves])
    loss32, g32 = loss_and_grads(model, p32, small)
    del p32
    loss16, g16 = loss_and_grads(model, params, small)
    hold_grads("train", f"(b) bf16 vs fp32 params, one step at B {TRAIN_CHECK_BATCH}",
               g16, g32, float(loss16), float(loss32))
    hold_every_leaf_moves("train", g16)
    del g16, g32
    release_memory()

    # the launcher's steps again with remat on, from the same weights and data
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(10, TRAIN_STEPS // 10))
    opt = init_opt_state(params)
    peak_reset(dev)
    remat_losses, t0 = {}, time.perf_counter()
    for step in range(TRAIN_STEPS):
        params, opt, loss, _ = train_step(model, params, opt,
                                          make_batch(cfg, data.batch(step, device=dev)),
                                          opt_cfg, remat=True)
        if step in launcher_losses:
            remat_losses[step] = (float(loss), time.perf_counter() - t0)
    peak_on = peak_bytes(dev)
    first, last = min(remat_losses), max(remat_losses)
    step_on = (remat_losses[last][1] - remat_losses[first][1]) / (last - first)
    log(f"[train] remat on: step wall {step_on * 1e3:.3f} ms, {tokens / step_on:.1f} tokens/s, "
        f"model FLOP/s {flops / step_on / 1e12:.2f} T, peak memory {peak_on} B "
        f"(remat off {peak_off} B)")
    for step, (loss, _) in remat_losses.items():
        rel = abs(loss - launcher_losses[step]) / max(1.0, abs(launcher_losses[step]))
        log(f"[train] (d) step {step}: loss remat on {loss:.6f}, off "
            f"{launcher_losses[step]:.6f} (rel {rel:.3e}, held {TRAIN_REMAT_TOL})")
        assert rel <= TRAIN_REMAT_TOL, (step, loss, launcher_losses[step])
    if dev.type == "cuda":
        assert peak_on < peak_off, (peak_on, peak_off)
        hold_step_never_syncs(model, params, opt, data, opt_cfg, cfg)
        profile_train_steps(model, params, opt, batch, opt_cfg, tokens, flops)
    del params, opt
    release_memory()

    # (c) one repeated batch: the loss must fall by more than 1 nat
    params = fresh()
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(10, TRAIN_REPEAT_STEPS // 10))
    losses = []
    for _ in range(TRAIN_REPEAT_STEPS):
        params, opt, loss, _ = train_step(model, params, opt, batch, opt_cfg)
        losses.append(loss)
    losses = [float(x) for x in torch.stack(losses).cpu()]
    log(f"[train] (c) {TRAIN_REPEAT_STEPS} steps on one batch: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (every 5th: "
        + ", ".join(f"{x:.3f}" for x in losses[::5]) + ")")
    assert losses[0] - losses[-1] > 1.0, losses
    return {"params": params, "opt": opt}


def hold_step_never_syncs(model, params, opt, data, opt_cfg, cfg):
    """One launcher step that prints nothing (its batch from the stream, the
    loss and gradients, AdamW) under `torch.cuda.set_sync_debug_mode("warn")`
    must not wait for the device; a blocking host-to-device copy under the
    same mode shows the probe sees a sync."""
    import warnings

    import torch

    from repro_torch.launch.train import make_batch, train_step

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return [str(w.message) for w in seen if "synchroniz" in str(w.message).lower()]

    probe = syncs(lambda: torch.ones(8).to("cuda"))
    step = syncs(lambda: train_step(model, params, opt,
                                    make_batch(cfg, data.batch(TRAIN_STEPS, device="cuda")),
                                    opt_cfg))
    log(f"[train] syncs in one unprinted launcher step: {len(step)} (a blocking copy "
        f"shows {len(probe)})" + (f"; first: {step[0][:200]}" if step else ""))
    assert probe and not step, (probe, step)


def profile_train_steps(model, params, opt, batch, opt_cfg, tokens, flops):
    """Device busy and idle share of the launcher's step (remat off) over
    TRAIN_PROFILE_STEPS steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            params, opt, _, _ = train_step(model, params, opt, batch, opt_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILE_STEPS
    by_name, n_kernels = _device_ms(prof, TRAIN_PROFILE_STEPS)
    if not by_name:
        log("[train] profile: device time not measured (the profiler saw no CUDA events)")
        return
    busy_ms = sum(by_name.values())
    kinds = {"matmul": ("gemm", "nvjet", "cutlass", "sm90", "xmma"),
             "elementwise": ("elementwise",), "reduce": ("reduce",)}
    by_kind = {k: 0.0 for k in (*kinds, "other")}
    for name, t in by_name.items():
        kind = next((k for k, words in kinds.items()
                     if any(w in name.lower() for w in words)), "other")
        by_kind[kind] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[train] profile of {TRAIN_PROFILE_STEPS} steps (remat off): wall {wall_ms:.3f} "
        f"ms/step, device busy {busy_ms:.3f} ms/step, busy share {busy_ms / wall_ms:.3f}, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {n_kernels / TRAIN_PROFILE_STEPS:.0f} "
        f"kernels/step, model FLOP/s over busy time {flops / (busy_ms / 1e3) / 1e12:.2f} T; "
        "by kind (ms/step): " + ", ".join(f"{k} {t:.3f}" for k, t in by_kind.items()))
    for name, t in top:
        log(f"[train] profile top: {t:.3f} ms/step {name[:160]}")


def checkpoint_round_trip(tree, cfg, device="cuda"):
    """Save `tree` through `CheckpointManager`, restore it onto `device` and
    compare every leaf bitwise; then delete the directory.  Where the disk
    cannot hold it, a fresh tree of `cfg` cut in depth to fit is saved."""
    import shutil

    import torch

    from repro_torch.models import build_model
    from repro_torch.models.tensors import flatten_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import init_opt_state

    dev = torch.device(device)

    def npz_bytes(t):  # bf16 is stored as f32
        return t.numel() * max(t.element_size(), 4)

    need = sum(npz_bytes(t) for _, t in flatten_params(tree))
    CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR.parent).free
    log(f"[train] checkpoint: {need} B of npz to write, {free} B free on the disk")
    if free < need * 1.2 + (2 << 30):
        import dataclasses

        per_layer = need / cfg.num_layers
        layers = max(1, int((free / 1.2 - (2 << 30)) // per_layer) - 1)
        cfg = dataclasses.replace(cfg, num_layers=layers)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                       max_positions=TRAIN_SEQ + 8, device=dev)
        tree = {"params": params, "opt": init_opt_state(params)}
        need = sum(npz_bytes(t) for _, t in flatten_params(tree))
        log(f"[train] checkpoint cut to {layers} of {cfg.num_layers} layers: {need} B")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(CKPT_DIR))
        sync(dev)
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, tree)
        capture_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in CKPT_DIR.rglob("*") if f.is_file())
        t0 = time.perf_counter()
        got = mgr.restore_latest(tree)
        sync(dev)
        restore_s = time.perf_counter() - t0
        same = [n for (n, a), (_, b) in zip(flatten_params(got), flatten_params(tree))
                if a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)]
        n_leaves = len(flatten_params(tree))
        log(f"[train] checkpoint round trip: capture {capture_s:.3f} s, save {save_s:.3f} s "
            f"({on_disk} B on disk, {on_disk / save_s / 1e9:.3f} GB/s), restore onto "
            f"{dev.type} {restore_s:.3f} s; {len(same)} of {n_leaves} leaves bitwise equal")
        assert len(same) == n_leaves
        del got
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def train_moe(device="cuda", smoke=False):
    """qwen3-moe-30b-a3b at full width with MOE_TRAIN_LAYERS of its layers
    through the launcher's loop under each dispatch, then one step's loss
    and gradients under the three dispatches at B 1 (the same function:
    one capacity over S*k), router choices replayed from gshard's."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import loss_and_grads, make_batch, train
    from repro_torch.models import build_model, param_count
    from repro_torch.train.data import BigramStream, DataConfig

    dev = torch.device(device)
    full = get_config(MOE_TRAIN_ARCH)
    cfg = full.smoke() if smoke else dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg)
    n = param_count(model.param_specs(max_positions=MOE_TRAIN_SEQ + 8))
    log(f"[train] {MOE_TRAIN_ARCH} cut to {cfg.num_layers} of {full.num_layers} layers: "
        f"{n} params, {n * 12} B of bf16 params and grads and fp32 moments")
    for impl, steps in (("gshard", MOE_TRAIN_STEPS), ("scatter", 1), ("grouped", 1)):
        peak_reset(dev)
        t0 = time.perf_counter()
        run, _ = logged(f"train {impl}", train, cfg, name=MOE_TRAIN_ARCH, steps=steps,
                        seq_len=MOE_TRAIN_SEQ, batch=1, lr=TRAIN_LR, moe_impl=impl,
                        device=device)
        wall = time.perf_counter() - t0
        log(f"[train] {impl}: {steps} step(s) in {wall:.3f} s with init, peak memory "
            f"{peak_bytes(dev)} B; losses " + ", ".join(f"{loss:.4f}" for _, loss, _, _ in run.printed))
        assert all(math.isfinite(loss) for _, loss, _, _ in run.printed)
        del run
        release_memory()

    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        max_positions=MOE_TRAIN_SEQ + 8, device=dev)
    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
                                   global_batch=1))
    batch = make_batch(cfg, data.batch(0, device=dev))
    choices = []
    with router_choices(record=choices):
        ref_loss, ref_grads = loss_and_grads(model, params, batch, moe_impl="gshard")
    hold_every_leaf_moves("train", ref_grads)
    for impl in ("scatter", "grouped"):
        with router_choices(replay=choices):
            loss, grads = loss_and_grads(model, params, batch, moe_impl=impl)
        hold_grads("train", f"{impl} vs gshard, one step at B 1, S {MOE_TRAIN_SEQ}",
                   grads, ref_grads, float(loss), float(ref_loss))
        del grads
    del ref_grads, params
    release_memory()


def train_launcher_contract(device="cuda", archs=None):
    """tests/test_launchers.py's contract for the training launcher, on
    `device`: a module run prints a loss, a relaunch resumes from its
    checkpoint, and every architecture takes TRAIN_LAUNCHER_STEPS steps at
    --smoke (in this process)."""
    import shutil

    from repro_torch.configs import arch_ids

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
           "--smoke", "--steps", "4", "--seq-len", "32", "--batch", "2", "--device", device]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        log(f"[train] module: {line}")
    if out.returncode != 0:
        raise RuntimeError(f"training launcher exited {out.returncode}:\n{out.stderr[-3000:]}")
    assert "loss" in out.stdout
    ckpt = CKPT_DIR.parent / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        base = ["--arch", "yi-9b", "--smoke", "--steps", "6", "--seq-len", "32", "--batch",
                "2", "--ckpt-every", "3", "--ckpt-dir", str(ckpt), "--device", device]
        run_train_main(base, "train resume")
        again = list(base)
        again[again.index("--steps") + 1] = "8"
        _, text = run_train_main(again, "train resume")
        assert "resumed from step 6" in text, text
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for arch in archs or arch_ids():
        run, text = run_train_main(["--arch", arch, "--smoke", "--steps",
                                    str(TRAIN_LAUNCHER_STEPS), "--seq-len", "32", "--batch",
                                    "2", "--device", device], f"train {arch}")
        assert "loss" in text and all(math.isfinite(x) for _, x, _, _ in run.printed), arch


def train_phase(device="cuda", smoke=False):
    """`[train]`: the training path on the card (training launches neither
    kernel: the loss runs the plain attention, as the reference's does)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(TRAIN_ARCH)
    if smoke:
        cfg = cfg.smoke()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tree = train_llama(cfg, device, smoke)
    log(f"[train] llama checks {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    checkpoint_round_trip(tree, cfg, device)
    del tree
    release_memory()
    log(f"[train] checkpoint {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    train_moe(device, smoke)
    log(f"[train] moe {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    train_launcher_contract(device)
    log(f"[train] launcher contract {time.perf_counter() - t0:.1f} s; {host_memory()}")
    counts = ops.launch_counts()
    log(f"[train] (e) kernel launches over the phase: {counts}")
    assert counts == {"paged_attention": 0, "flash_attention": 0, "moe_experts": 0,
                      "rope_kv_write": 0, "add_rms_norm": 0}, counts
    if torch.device(device).type == "cuda":
        release_memory()


# ------------------------------------------------------------ [distributed]
DIST_ARCH = "llama3.2-1b"
DIST_TRAIN = (8, 512)  # (B, S): make_train_step, remat on, bf16
DIST_TRAIN_STEPS = 3
DIST_PREFILL = (4, 512)  # (B, S): make_prefill_step, K2 through local_map
DIST_SERVE_TOKENS = 8  # make_serve_step over the prefill's 512-slot caches
DIST_SMOKE = {"train": (2, 32), "prefill": (2, 32), "tokens": 2}
COMPRESS_TOL = 0.02  # relative error of the int8 gradient (tests/test_compress.py:65-66)
DRYRUNS = (("--arch", DIST_ARCH, "--mesh", "single"),
           ("--arch", DIST_ARCH, "--shape", "train_4k", "--mesh", "multi"))
DRYRUN_SMOKE = (("--arch", DIST_ARCH, "--shape", "decode_32k", "--mesh", "single"),)


def start_dryruns(tmp: str, smoke: bool) -> list:
    """The dry-run in processes of its own (one default process group each:
    a fake one of 512 ranks), started together so that they trace on the
    host while the card runs the steps.  Returns (argv, out path, process)."""
    procs = []
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for i, args in enumerate(DRYRUN_SMOKE if smoke else DRYRUNS):
        out = os.path.join(tmp, f"dryrun_{i}.json")
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out]
        procs.append((args, out, subprocess.Popen(argv, cwd=ROOT, env=env,
                                                   stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs, timeout: float = 600) -> None:
    """Wait for the dry-runs; each must exit 0.  Prints each row's
    bottleneck, roofline terms, useful-FLOPs ratio and trace time."""
    for args, out, proc in procs:
        try:
            text, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        for line in text.splitlines():
            if line.startswith(("[ ok ]", "[FAIL]", "done:")):
                log(f"[distributed] dryrun {line}")
        assert proc.returncode == 0, (args, proc.returncode, text[-3000:])
        with open(out) as f:
            rows = json.load(f)
        for key, row in sorted(rows.items()):
            if row.get("skipped"):
                continue
            log(f"[distributed] dryrun {key}: bottleneck {row['bottleneck']}, compute "
                f"{row['compute_s'] * 1e3:.3f} ms, memory {row['memory_s'] * 1e3:.3f} ms, "
                f"collective {row['collective_s'] * 1e3:.3f} ms, useful FLOPs ratio "
                f"{row['useful_flops_ratio']:.4f}, per chip {row['hlo_flops_per_chip']:.6e} "
                f"FLOP / {row['collective_bytes_per_chip']:.6e} collective B, args "
                f"{row['memory_analysis']['argument_bytes']} B, trace_s {row['trace_s']}")


def timed(dev, fn, *args, **kw):
    """(fn(*args, **kw), host wall in ms ending in a device sync)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def full(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def bitwise(a, b) -> bool:
    """Every leaf of `a` (DTensors or not) equals `b`'s to the bit."""
    import torch

    from repro_torch.models.tensors import flatten_params

    return all(torch.equal(full(x), y) for (_, x), (_, y)
               in zip(flatten_params(a), flatten_params(b)))


def dist_train(cfg, model, mesh, params, dev, smoke):
    """make_train_step against launch.train.train_step on the same params
    and batch: the gradients first, then 3 steps of each."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.launch import train as launcher
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    B, S = DIST_SMOKE["train"] if smoke else DIST_TRAIN
    shape = ShapeConfig("distributed_train", S, B, "train")
    gen = torch.Generator().manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32).to(dev)
    batch = launcher.make_batch(cfg, tokens)
    bundle = steps.make_train_step(cfg, mesh, shape, remat=True)
    clone = functools.partial(tree_map, lambda t: t.clone())
    d_params, d_opt, d_batch = bundle.place(clone(params), init_opt_state(params), batch)
    with implicit_replication():
        loss_d, grads_d = steps.loss_and_grads(model, d_params, d_batch, remat=True,
                                               moe_impl="gshard")
    loss_u, grads_u = launcher.loss_and_grads(model, params, batch, remat=True)
    hold_grads("distributed", "make_train_step's gradients vs launch.train's",
               tree_map(full, grads_d), grads_u, float(full(loss_d)), float(loss_u))
    del grads_d, grads_u
    u_params, u_opt, opt_cfg = clone(params), init_opt_state(params), AdamWConfig()
    for step in range(DIST_TRAIN_STEPS):
        (d_params, d_opt, loss_d), ms_d = timed(dev, bundle.fn, d_params, d_opt, d_batch)
        (u_params, u_opt, loss_u, _), ms_u = timed(
            dev, launcher.train_step, model, u_params, u_opt, batch, opt_cfg, remat=True)
        rel = abs(float(full(loss_d)) - float(loss_u)) / max(1.0, abs(float(loss_u)))
        log(f"[distributed] train step {step}: {ms_d:.3f} ms on the 1x1 mesh vs "
            f"{ms_u:.3f} ms undistributed (B {B}, S {S}, remat on); loss "
            f"{float(full(loss_d)):.6f} vs {float(loss_u):.6f} (rel {rel:.3e})")
        assert rel <= TRAIN_LOSS_TOL, (step, rel)
    errs = grad_errors(tree_map(full, d_params), u_params)
    worst = max(errs, key=errs.get)
    log(f"[distributed] params after {DIST_TRAIN_STEPS} steps: bitwise equal "
        f"{bitwise(d_params, u_params)}, worst leaf {worst} rel L2 {errs[worst]:.3e}")
    assert errs[worst] <= TRAIN_GRAD_TOL, (worst, errs[worst])


def dist_serve(cfg, model, mesh, params, dev, smoke):
    """make_prefill_step (K2 on each rank's heads) and make_serve_step
    against Model.prefill / Model.decode and the plain attention."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    B, S = DIST_SMOKE["prefill"] if smoke else DIST_PREFILL
    gen = torch.Generator().manual_seed(18)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     dtype=torch.int32).to(dev)}
    prefill = steps.make_prefill_step(cfg, mesh, ShapeConfig("distributed_prefill", S, B,
                                                             "prefill"))
    d_params, d_batch = prefill.place(params, batch)
    before = ops.launch_counts()["flash_attention"]
    (last_d, cache_d), ms_cold = timed(dev, prefill.fn, d_params, d_batch)
    launches = ops.launch_counts()["flash_attention"] - before
    # a second call, once DTensor's sharding propagation is cached
    (last_d, cache_d), ms_d = timed(dev, prefill.fn, d_params, d_batch)
    with torch.no_grad():
        (logits_u, cache_u), ms_u = timed(dev, model.prefill, params, batch, cache_cap=S)
        plain, _ = lm.forward(params, cfg, batch["tokens"], kernel_attention=False, remat=False)
    last_u = logits_u[:, -1]
    tol = TOL[cfg.dtype]
    err_u, err_p = rel_err(full(last_d), last_u), rel_err(full(last_d), plain[:, -1])
    log(f"[distributed] prefill step: {ms_cold:.3f} ms first, {ms_d:.3f} ms second on the "
        f"1x1 mesh vs {ms_u:.3f} ms Model.prefill (B {B}, S {S}); K2 launches inside one "
        f"call {launches}; last logits vs "
        f"Model.prefill {err_u:.3e}, vs the plain attention {err_p:.3e} of scale (held {tol}); "
        f"bitwise equal to Model.prefill {bool(torch.equal(full(last_d), last_u))}")
    assert launches == cfg.num_layers if full(last_d).is_cuda else launches == 0, launches
    assert err_u <= tol and err_p <= tol, (err_u, err_p)
    del plain, logits_u
    serve = steps.make_serve_step(cfg, mesh, ShapeConfig("distributed_serve", S, B, "decode"))
    token = last_u.argmax(-1).to(torch.int32)
    for i in range(DIST_SMOKE["tokens"] if smoke else DIST_SERVE_TOKENS):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        d_token, d_pos = serve.place(params, token, pos)[1:3]
        (logits_d, cache_d), ms_d = timed(dev, serve.fn, d_params, d_token, d_pos, cache_d)
        with torch.no_grad():
            (logits_u, cache_u), ms_u = timed(dev, model.decode, params, token, pos, cache_u)
        err = rel_err(full(logits_d), logits_u)
        log(f"[distributed] serve step {i} (pos {S + i}, ring of {S}): {ms_d:.3f} ms on the "
            f"1x1 mesh vs {ms_u:.3f} ms Model.decode; logits {err:.3e} of scale (held {tol}), "
            f"bitwise equal {bool(torch.equal(full(logits_d), logits_u))}")
        assert err <= tol, (i, err)
        token = logits_u.argmax(-1).to(torch.int32)  # both runs take the same token


def dist_elastic(cfg, model, mesh, params, dev):
    """A checkpoint of the train step's placed parameters (each DTensor leaf
    written whole by rank 0) restored onto the prefill step's placements
    (`restore(..., shardings=)`): every leaf bitwise equal, on the card,
    with the requested mesh and placements."""
    import shutil

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
    from repro_torch.train.checkpoint import restore, save

    shape = ShapeConfig("distributed_elastic", 512, 8, "train")
    placed = steps.make_train_step(cfg, mesh, shape).place(params)[0]
    to = steps.make_prefill_step(cfg, mesh, ShapeConfig("distributed_elastic", 512, 4,
                                                        "prefill"))
    pairs = [(mesh, shd.placements(s, mesh)) for s in shd.spec_leaves(to.specs[0])]
    directory = ROOT / "build" / "elastic_ckpt"
    t0 = time.perf_counter()
    save(str(directory), 1, placed)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = restore(str(directory), placed,
                  shardings=tree_unflatten(tree_structure(params), pairs))
    restore_s = time.perf_counter() - t0
    wrong = [n for (n, t), (m, pl) in zip(flatten_params(got), pairs)
             if t.device_mesh is not m or tuple(t.placements) != pl or t.device.type != dev.type]
    same = bitwise(got, params)
    log(f"[distributed] elastic checkpoint of {len(pairs)} placed leaves "
        f"({sum(t.numel() * t.element_size() for _, t in flatten_params(params))} B): "
        f"save {save_s:.1f} s, restore onto the prefill step's placements {restore_s:.1f} s; "
        f"bitwise equal {same}, leaves off their requested placement {wrong}")
    shutil.rmtree(directory, ignore_errors=True)
    assert same and not wrong, wrong


def dist_compress(mesh, dev):
    """compressed_grad_fn on the one-rank group: int8 on the wire, within
    COMPRESS_TOL of the exact gradient, a nonzero residual."""
    import torch

    from repro_torch.distributed.compress import compressed_grad_fn, residual_like

    gen = torch.Generator().manual_seed(19)
    params = {"w1": (torch.randn(1024, 4096, generator=gen) * 0.03).to(dev),
              "w2": (torch.randn(4096, 1024, generator=gen) * 0.03).to(dev)}
    batch = {"x": torch.randn(256, 1024, generator=gen).to(dev),
             "y": torch.randn(256, 1024, generator=gen).to(dev)}

    def loss_fn(w, b):
        return ((torch.tanh(b["x"] @ w["w1"]) @ w["w2"] - b["y"]) ** 2).mean()

    (grads, residual, loss), ms = timed(dev, compressed_grad_fn(loss_fn, mesh, ("data",)),
                                        params, batch, residual_like(params))
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    exact = dict(zip(p, torch.autograd.grad(loss_fn(p, batch), list(p.values()))))
    rel = max(float((grads[k] - exact[k]).abs().max() / exact[k].abs().max()) for k in p)
    res = float(sum(r.abs().sum() for r in residual.values()))
    log(f"[distributed] compressed_grad_fn (int8 all-gather, 1 rank, MLP 1024x4096x1024): "
        f"{ms:.3f} ms, max relative error {rel:.3e} (held {COMPRESS_TOL}), residual L1 "
        f"{res:.4e}, loss {float(loss):.6f}")
    assert rel < COMPRESS_TOL and res > 0, (rel, res)


def distributed_phase(device="cuda", smoke=False) -> dict:
    """`[distributed]`: the distributed steps on a 1x1 mesh of a one-rank
    process group (NCCL on the card, gloo on the CPU; a FileStore, no
    network) at llama3.2-1b's full width and depth, compressed gradients,
    and the dry-run in its own processes.  Returns K2's launches there."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    before = ops.launch_counts()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # the rank's device, before the mesh (NCCL)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    procs = start_dryruns(tmp, smoke)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh((1, 1), device_type=dev.type)
        cfg = get_config(DIST_ARCH)
        if smoke:
            cfg = cfg.smoke()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        t0 = time.perf_counter()
        dist_train(cfg, model, mesh, params, dev, smoke)
        log(f"[distributed] train {time.perf_counter() - t0:.1f} s; {host_memory()}")
        t0 = time.perf_counter()
        dist_serve(cfg, model, mesh, params, dev, smoke)
        log(f"[distributed] prefill and serve {time.perf_counter() - t0:.1f} s; {host_memory()}")
        t0 = time.perf_counter()
        dist_elastic(cfg, model, mesh, params, dev)
        log(f"[distributed] elastic checkpoint {time.perf_counter() - t0:.1f} s; "
            f"{host_memory()}")
        del params
        dist_compress(mesh, dev)
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    finish_dryruns(procs)
    log(f"[distributed] dry-run waited {time.perf_counter() - t0:.1f} s more; {host_memory()}")
    if dev.type == "cuda":
        release_memory()
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    log(f"[distributed] kernel launches over the phase: {counts}")
    return counts


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
    log(f"[phase] kernels {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    counts = main_path()
    log(f"[phase] main path {time.perf_counter() - t0:.1f} s; {host_memory()}")
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfgs = {m: get_config(m) for m in SERVERLESS_MODELS}
    weights = {m: draw_weights(cfg, seed) for seed, (m, cfg) in enumerate(cfgs.items())}
    log(f"[phase] weights drawn {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    launches = serverless_phase(cfgs, weights)
    log(f"[phase] serverless {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    fleet_phase(cfgs, weights)
    log(f"[phase] fleet {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    trace_phase(cfgs[TRACE_ARCH], weights[TRACE_ARCH])
    log(f"[phase] trace {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    graphs_phase(cfgs[TRACE_ARCH], weights[TRACE_ARCH])
    log(f"[phase] graphs {time.perf_counter() - t0:.1f} s; {host_memory()}")
    # deepseek-7b's page-locked tree serves [dedup] and [migration] too
    big = weights.pop("deepseek-7b")
    del weights
    release_memory()
    t0 = time.perf_counter()
    dedup_phase(cfgs["deepseek-7b"], big)
    log(f"[phase] dedup {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    migration_phase(cfgs["deepseek-7b"], big)
    log(f"[phase] migration {time.perf_counter() - t0:.1f} s; {host_memory()}")
    del big
    release_memory()
    log(f"[phase] memory released; {host_memory()}")
    t0 = time.perf_counter()
    fcfgs = family_configs()
    weights = {m: draw_weights(cfg, 10 + seed) for seed, (m, cfg) in enumerate(fcfgs.items())}
    log(f"[phase] family weights drawn {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    launches.update(families_phase(fcfgs, weights))
    log(f"[phase] families {time.perf_counter() - t0:.1f} s; {host_memory()}")
    del weights
    release_memory()
    t0 = time.perf_counter()
    dcfgs = {m: get_config(m) for m in DENSE_MODELS}
    weights = {m: draw_weights(cfg, 30 + seed) for seed, (m, cfg) in enumerate(dcfgs.items())}
    log(f"[phase] dense weights drawn {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    launches.update(dense_phase(dcfgs, weights))
    log(f"[phase] dense {time.perf_counter() - t0:.1f} s; {host_memory()}")
    del weights
    release_memory()
    t0 = time.perf_counter()
    launches.update(mla_phase())
    log(f"[phase] mla {time.perf_counter() - t0:.1f} s; {host_memory()}")
    release_memory()
    t0 = time.perf_counter()
    scfgs = state_configs()
    weights = {m: draw_weights(cfg, 20 + seed) for seed, (m, cfg) in enumerate(scfgs.items())}
    log(f"[phase] state-family weights drawn {time.perf_counter() - t0:.1f} s; "
        f"{host_memory()}")
    t0 = time.perf_counter()
    launches.update(state_families_phase(scfgs, weights))
    recurrence_timing(scfgs)
    log(f"[phase] state-families {time.perf_counter() - t0:.1f} s; {host_memory()}")
    del weights
    release_memory()
    t0 = time.perf_counter()
    launcher_phase()
    log(f"[phase] launcher {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    examples_phase()
    log(f"[phase] examples {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    train_phase()
    log(f"[phase] train {time.perf_counter() - t0:.1f} s; {host_memory()}")
    t0 = time.perf_counter()
    launches["distributed"] = distributed_phase()
    log(f"[phase] distributed {time.perf_counter() - t0:.1f} s; {host_memory()}")
    for (name, label), row in rows.items():
        row["launches"] = counts[name] if label == "main" else launches[label][name]
    kernels = [{k: rows[key][k] for k in ("name", "route", "source", "replaces", "shape",
                                          "launches", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}
               for key in sorted(rows, key=lambda key: (list(SHAPE_NOTES).index(key[1]),
                                                         key[0] != "paged_attention"))]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
