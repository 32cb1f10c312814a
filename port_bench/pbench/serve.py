"""The measured window: the program's serverless entry point, driven from
outside.

`Gateway.run_trace` over one `Engine` with its defaults (CUDA graphs on).
The benchmark subclasses both only to read what they do, never to change
it:

  * `RecordingEngine.load` keeps each load's `DataLoadStats` and
    `LoadReport`; `start_instance` hands the Gateway an `InstanceRecorder`,
    which forwards every call to the program's `Instance` and keeps the
    served tokens as the decode loop passes them in (device tensors, no
    host read), and at `finish` the last one, from the last logits;
  * `BenchGateway._prefill_batch` gives request j the prompt the benchmark
    drew for it from the run's seed (the program's own draws from the
    request's index in its slice alone).

With a `Tracer` (the traced run only) the recorder adds a span around each
prefill and each decode step, on the tracer's clock.
"""
from __future__ import annotations

import itertools
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from pbench.traffic import Arrival, mix


WINDOW_PROMPTS = 1  # the stream of the run's seed the trace's prompts come from


def prompt_tokens(seed: int, stream: int, index: int, length: int, vocab: int) -> torch.Tensor:
    """Prompt `index` of `stream`, (1, length) int32 on the host, from `seed`."""
    gen = torch.Generator().manual_seed(mix(seed, stream, index))
    return torch.randint(0, vocab, (1, length), generator=gen, dtype=torch.int32)


class InstanceRecorder:
    """The Gateway's view of one `Instance`: every call goes through."""

    def __init__(self, inst, served: list, tracer):
        self._inst = inst
        self._served = served  # the request's tokens, appended in order
        self._tracer = tracer
        self._last = None

    def prefill(self, batch):
        if self._tracer is None:
            return self._inst.prefill(batch)
        with self._tracer.span("bench.prefill", track="bench", cat="bench"):
            return self._inst.prefill(batch)

    def decode(self, token):
        self._served.append(token)
        if self._tracer is None:
            self._last = self._inst.decode(token)
        else:
            with self._tracer.span("bench.decode_step", track="bench", cat="bench"):
                self._last = self._inst.decode(token)
        return self._last

    def finish(self):
        if self._last is not None:
            self._served.append(torch.argmax(self._last, -1).to(torch.int32))
        self._inst.finish()


def engine_classes():
    """(RecordingEngine, BenchGateway), built on the program's classes when
    first asked for (the program is imported inside the run)."""
    from repro_torch.serverless.gateway import Gateway
    from repro_torch.serving.engine import Engine

    class RecordingEngine(Engine):
        def __init__(self, *args, bench_tracer=None, **kw):
            super().__init__(*args, **kw)
            self.loads: list = []  # (model_id, DataLoadStats, LoadReport) per load
            self.served: list[list] = []  # per request, its token tensors
            self.bench_tracer = bench_tracer

        def load(self, model_id, **kw):
            rep = super().load(model_id, **kw)
            self.loads.append((model_id, self.last_load, rep))
            return rep

        def start_instance(self, model_id, **kw):
            tokens: list = []
            self.served.append(tokens)
            return InstanceRecorder(super().start_instance(model_id, **kw), tokens,
                                    self.bench_tracer)

    class BenchGateway(Gateway):
        def __init__(self, engine, *, seed: int, **kw):
            super().__init__(engine, **kw)
            self.seed = seed
            self.offset = 0  # the global index of the slice's first request
            self.prompts: list[torch.Tensor] = []  # per request, on the host

        def _prefill_batch(self, model_id, i):
            vocab = self.engine.models[model_id].cfg.vocab_size
            tokens = prompt_tokens(self.seed, WINDOW_PROMPTS, self.offset + i,
                                   self.prompt_len, vocab)
            self.prompts.append(tokens)
            return {"tokens": tokens.to(self.engine.device)}

    return RecordingEngine, BenchGateway


@dataclass
class Served:
    """What one request did: its arrival, its `TTFTRecord`, its load, its
    prompt and its served tokens."""

    arrival: Arrival
    record: object
    load: tuple
    prompt: torch.Tensor
    tokens: list
    failed: bool = False


@dataclass
class Window:
    served: list[Served] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    failed: int = 0
    graphs_before: tuple = (0, 0, 0)
    graphs_after: tuple = (0, 0, 0)


def graph_counts(engine) -> tuple[int, int, int]:
    """(eager steps, captures, replays) of the engine's compiled steps."""
    g = engine.step_graphs
    return (0, 0, 0) if g is None else (g.eager_steps, g.captures, g.replays)


def serve(gateway, trace: Iterator[Arrival], index: int, slice_n: int, *, until=None,
          count: int | None = None, window: Window | None = None) -> int:
    """Serve the next arrivals of `trace` (request `index` of the run first)
    in slices of `slice_n` through `run_trace` until the trace ends, `count`
    requests are served or, at a slice's end, the wall clock passes `until`
    (the first slice is always served).  Appends each request to `window`.
    Returns the next index."""
    from repro_torch.core.trace import Request

    eng = gateway.engine
    end = math.inf if count is None else index + count
    first = True
    while index < end and (first or until is None or time.perf_counter() < until):
        first = False
        part = list(itertools.islice(trace, min(slice_n, end - index)))
        if not part:
            break
        reqs = [Request(time=a.time, model_id=a.model_id, dataset="bench",
                        prompt_tokens=gateway.prompt_len, output_tokens=gateway.gen_tokens,
                        batch_size=1) for a in part]
        n_rec, n_load = len(gateway.sink.records), len(eng.loads)
        gateway.offset = index
        failed = False
        try:
            gateway.run_trace(reqs)
        except Exception as e:  # a request that raises counts as failed
            failed = True
            print(f"port_bench: request {index + len(gateway.sink.records) - n_rec} "
                  f"raised {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        if window is not None:
            recs = gateway.sink.records[n_rec:]
            loads = eng.loads[n_load:]
            for j, a in enumerate(part):
                ok = j < len(recs)
                window.served.append(Served(
                    arrival=a, record=recs[j] if ok else None,
                    load=loads[j] if j < len(loads) else None,
                    prompt=gateway.prompts[index + j] if index + j < len(gateway.prompts) else None,
                    tokens=eng.served[index + j] if index + j < len(eng.served) else [],
                    failed=not ok))
                window.failed += not ok
        if failed:
            # the Gateway's state after a raise is the program's; go on with the
            # next slice at the next index, as a client would
            gateway.prompts += [None] * (index + len(part) - len(gateway.prompts))
            eng.served += [[]] * (index + len(part) - len(eng.served))
        index += len(part)
    return index
