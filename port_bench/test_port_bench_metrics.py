"""Each metric reader's arithmetic on hand-built records, the counts behind
the roofline shares, and the traffic generator."""
import itertools
import json
import math
from pathlib import Path

import pytest

from repro_torch.serverless.gateway import TTFTRecord
from repro_torch.serving.engine import DataLoadStats

from pbench import cell, counts, stats, traffic
from pbench.probe import DeviceTrace, Profiled, StepReading, _union, read_slice
from pbench.serve import Served, Window

HERE = Path(__file__).resolve().parent
DENSE = json.loads((HERE / "configs" / "dense-trio.json").read_text())
MOE = json.loads((HERE / "configs" / "moe-duo.json").read_text())
PORT = {m["id"]: m["port"] for m in DENSE["models"] + MOE["models"]}


def served(model, ttft_parts, decode_s, stats_kw, cold=True):
    q, i, ld, p, pf = ttft_parts
    rec = TTFTRecord(model_id=model, arrival=0.0, cold=cold, queue_s=q, init_s=i, load_s=ld,
                     profile_s=p, prefill_s=pf, decode_s=decode_s)
    return Served(arrival=traffic.Arrival(0.0, model), record=rec,
                  load=(model, DataLoadStats(**stats_kw), None), prompt=None, tokens=[])


@pytest.fixture
def ctx():
    tf = {"decode_steps": 16}
    win = Window(start=10.0, end=12.0, graphs_before=(5, 1, 100), graphs_after=(7, 2, 148))
    win.served = [
        served("a", (0.5, 0.0, 0.2, 0.0, 0.1), 0.32, dict(bytes_device_hit=60, bytes_h2d=40,
                                                          transfer_seconds=1e-6), cold=True),
        served("b", (0.0, 0.0, 0.0, 0.0, 0.2), 0.16, dict(bytes_device_hit=100), cold=False),
        served("a", (1.0, 0.0, 0.4, 0.0, 0.1), 0.48, dict(bytes_device_hit=20, bytes_h2d=80,
                                                          transfer_seconds=3e-6), cold=True),
    ]
    return cell.Context(cfgs=PORT, traffic=tf, window=win, model_bytes={"a": 100, "b": 100})


def read(kind, name, ctx):
    return cell.reader(kind, name)(ctx)


def test_end_to_end_readers(ctx):
    # ttfts 0.8, 0.2, 1.5; percentile index min(n - 1, int(n q))
    assert read("end_to_end", "ttft_p90_s", ctx) == pytest.approx(1.5)
    assert read("end_to_end", "cold_start_p90_s", ctx) == pytest.approx(0.5)  # of 0.3, 0.5
    assert read("end_to_end", "tpot_p90_ms", ctx) == pytest.approx(0.48 / 16 * 1e3)
    assert read("end_to_end", "tokens_per_s", ctx) == pytest.approx(3 * 17 / 2.0)


def test_program_counter_readers(ctx):
    assert read("metrics", "gateway.queue_share", ctx) == pytest.approx(100 * 1.5 / 2.5)
    assert read("metrics", "load.reuse_share", ctx) == pytest.approx(100 * 180 / 300)
    assert read("metrics", "load.h2d_gbps", ctx) == pytest.approx(120 / 4e-6 / 1e9)
    assert read("metrics", "graphs.replay_share", ctx) == pytest.approx(100 * 48 / 50)


def test_a_cold_cell_reads_as_the_warm_one(ctx):
    """Each `.cold` reader is its plain namesake's reading, under its own
    name (and so its own bound and its own `moves`)."""
    ctx.steps = [StepReading("deepseek-7b", 256, prefill_s=0.01, k2_s=3e-4, decode_step_s=8e-3,
                             k1_step_s=2.4e-4, mean_length=284.5, steps=16)]
    ctx.slice = DeviceTrace(window_s=2.0, busy_s=1.5)
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for kind, items in (("end_to_end", spec["end_to_end"]), ("metrics", spec["per_layer"])):
        cold = [m["name"] for m in items if m["name"].endswith(".cold")]
        assert cold, kind
        for name in cold:
            assert read(kind, name, ctx) == read(kind, name[: -len(".cold")], ctx), name


def test_readers_with_nothing_to_read(ctx):
    for s in ctx.window.served:
        s.load[1].bytes_h2d = 0
    ctx.window.graphs_after = ctx.window.graphs_before
    assert read("metrics", "load.h2d_gbps", ctx) is None
    assert read("metrics", "graphs.replay_share", ctx) is None
    for name in ("prefill.mfu", "decode.mfu", "decode.hbm_share", "k1_roofline",
                 "k2_roofline", "moe_experts_roofline", "device.idle_share"):
        assert read("metrics", name, ctx) is None, name
    ctx.window.served = []
    assert read("end_to_end", "ttft_p90_s", ctx) is None
    assert read("end_to_end", "tokens_per_s", ctx) is None


def test_device_readers(ctx):
    cfg = PORT["deepseek-7b"]
    ctx.steps = [StepReading("deepseek-7b", 256, prefill_s=0.01, k2_s=3e-4, decode_step_s=8e-3,
                             k1_step_s=2.4e-4, mean_length=284.5, steps=16)]
    ctx.slice = DeviceTrace(window_s=2.0, busy_s=1.5)
    flops = counts.prefill_flops(cfg, 256)
    assert read("metrics", "prefill.mfu", ctx) == pytest.approx(100 * flops / (0.01 * 989e12))
    assert read("metrics", "decode.mfu", ctx) == pytest.approx(
        100 * counts.decode_flops(cfg, 284.5) / (8e-3 * 989e12))
    assert read("metrics", "decode.hbm_share", ctx) == pytest.approx(
        100 * counts.decode_bytes(cfg, 284.5) / 3.35e12 / 8e-3)
    k1 = 30 * counts.k1_bytes(cfg, 284.5 - 16, 64) / 3.35e12
    assert read("metrics", "k1_roofline", ctx) == pytest.approx(100 * k1 / 2.4e-4)
    assert read("metrics", "k2_roofline", ctx) == pytest.approx(
        100 * 30 * counts.k2_bound(cfg, 256) / 3e-4)
    assert read("metrics", "device.idle_share", ctx) == pytest.approx(25.0)


def test_moe_experts_roofline(ctx):
    """The routed experts' least time over their kernels' time in the
    replays, of the models that ran them; a dense model is left out, and
    with no model that ran them the metric is silent."""
    moe = PORT["qwen3-moe-30b-a3b"]
    per_layer = 8 * 3 * 2048 * 768 * 2 + 2 * 2048 * 2 + 8 * 13
    assert counts.moe_experts_bytes(moe) == per_layer
    assert counts.moe_layers(moe) == 12 and counts.moe_layers(PORT["deepseek-7b"]) == 0
    step = dict(prefill_s=0.03, k2_s=3e-4, decode_step_s=2.6e-3, k1_step_s=1e-4,
                mean_length=536.5, steps=16)
    ctx.steps = [StepReading("deepseek-7b", 512, **step),
                 StepReading("qwen3-moe-30b-a3b", 512, **step, experts_step_s=4.8e-4)]
    assert read("metrics", "moe_experts_roofline", ctx) == pytest.approx(
        100 * 12 * per_layer / 3.35e12 / 4.8e-4)
    ctx.steps = [StepReading("qwen3-moe-30b-a3b", 15, **step, experts_step_s=4.8e-4)]
    assert read("metrics", "moe_experts_roofline", ctx) == pytest.approx(
        100 * 12 * per_layer / 3.35e12 / 4.8e-4)  # whatever path the prefill took
    ctx.steps = [StepReading("qwen3-moe-30b-a3b", 512, **step)]
    assert read("metrics", "moe_experts_roofline", ctx) is None  # off the path


def test_counts_by_hand():
    ds = PORT["deepseek-7b"]
    attn = 4096 * 32 * 128 * 4
    mlp = 3 * 4096 * 11008
    assert counts.attn_params(ds) == attn and counts.mlp_params(ds) == mlp
    assert counts.prefill_flops(ds, 4) == (2 * (attn + mlp) * 4 * 30
                                           + 4 * 32 * 128 * 10 * 30 + 2 * 4096 * 102400)
    cq = PORT["codeqwen1.5-7b"]  # GQA, 4 KV heads, with q/k/v biases
    assert counts.attn_params(cq) == 4096 * 128 * (2 * 32 + 2 * 4) + (32 + 8) * 128
    moe = PORT["qwen3-moe-30b-a3b"]
    # a decode step reads the 8 routed experts of 128, and the fp32 router
    per_layer = ((2048 * 32 * 128 * 2 + 2048 * 4 * 128 * 2 + 8 * 3 * 2048 * 768) * 2
                 + 2048 * 128 * 4 + 2 * 2048 * 4)
    kv = 2 * 4 * 128 * 2 * 11 * 12
    assert counts.decode_bytes(moe, 10) == (per_layer * 12 + 2048 * 151936 * 2 + 2048 * 4
                                            + 2048 * 2 + kv + 4 * 151936)
    # K2 at S 4096 is bound by its operations, at S 256 by its bytes
    assert counts.bound(1, 1e15)[1] == "operations" and counts.bound(1e12, 1)[1] == "bytes"
    assert counts.k2_bound(ds, 256) == pytest.approx(((2 * 32 + 2 * 32) * 256 * 128 * 2) / 3.35e12)


def test_percentile_and_spread():
    assert stats.percentile([3, 1, 2], 0.5) == 2
    assert stats.percentile([], 0.9) == 0.0
    assert stats.percentile(list(range(100)), 0.9) == 90
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)


def test_union_and_slice_gaps():
    assert _union([(5, 7), (1, 3), (2, 4)]) == [[1, 4], [5, 7]]

    class P:
        t0, t1, shift = 0.0, 1e-6, 0  # 1000 ns
        events = [("k", 100, 300), ("k", 250, 400), ("c", 600, 700)]

    dt = read_slice(P, [("load", 0.0, 5e-7), ("prefill", 5e-7, 1e-6)])
    assert dt.busy_s == pytest.approx(400e-9) and dt.window_s == pytest.approx(1e-6)
    assert dt.ops == {"k": pytest.approx(350e-9), "c": pytest.approx(100e-9)}
    # gaps: 0-100 and 400-600 inside `load`, 700-1000 inside `prefill`
    assert dt.gaps[0] == ("prefill", pytest.approx(300e-9))
    assert sorted(g for n, g in dt.gaps if n == "load") == [pytest.approx(100e-9),
                                                            pytest.approx(200e-9)]


def test_kernel_seconds_from_a_host_instant():
    """The kernels' time from a host instant on (the profiler's clock is the
    host's plus `shift`); none where no shift is known."""
    class P:
        shift = 0
        events = [("k", 100, 300), ("k", 250, 400), ("c", 600, 700)]

    assert Profiled.kernel_seconds(P, "k") == pytest.approx(350e-9)
    assert Profiled.kernel_seconds(P, "k", 200) == pytest.approx(150e-9)
    P.shift = 100
    assert Profiled.kernel_seconds(P, "k", 100) == pytest.approx(150e-9)
    P.shift = None
    assert Profiled.kernel_seconds(P, "k", 0) == 0.0
    assert Profiled.kernel_seconds(P, "c") == pytest.approx(100e-9)


@pytest.mark.parametrize("name", ["dense-trio.switch", "moe-duo.chat"])
def test_the_trace_offers_the_files_work(name):
    """Every block holds the same gaps and model counts, in another order."""
    tf = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    block = tf["block"]
    trace = list(itertools.islice(traffic.arrivals(tf), block * 4))
    assert trace == list(itertools.islice(traffic.arrivals(tf), block * 4))
    times = [0.0] + [a.time for a in trace]
    blocks = [(sorted(round(b - a, 9) for a, b in zip(times[i:i + block], times[i + 1:i + block + 1])),
               sorted(a.model_id for a in trace[i:i + block])) for i in range(0, 4 * block, block)]
    assert all(b == blocks[0] for b in blocks)
    assert [a.model_id for a in trace[:block]] != [a.model_id for a in trace[block:2 * block]]
    assert times[-1] / (4 * block) == pytest.approx(1 / tf["rate_per_s"], rel=0.1)
    counts_ = traffic.block_counts(traffic.popularity(len(tf["ranks"]), tf["zipf"]), block)
    assert sum(counts_) == block and counts_ == sorted(counts_, reverse=True)
    other = traffic.arrivals(dict(tf, order_seed=tf["order_seed"] + 1))
    assert list(itertools.islice(other, block)) != trace[:block]


def test_exponential_quantiles_and_mix():
    assert traffic.mix(2**40, 1) != traffic.mix(2**40, 2) and 0 <= traffic.mix(2**62, 3) < 2**63
    assert traffic.exponential_gaps(1.0, 2) == [-math.log(0.75), -math.log(0.25)]
