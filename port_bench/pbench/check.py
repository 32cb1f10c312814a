"""Whether the window served the right tokens: the comparison behind
`correct`.

Once the window has closed and the program's state is freed, a sample of
the window's finished requests, drawn from the run's seed, is run through
the plain float32 reference of the request's model (the module its
configuration entry names, `reference/lm.py` by default;
`reference/__init__.py` states the contract), over each request's prompt
and the tokens it served.  At every served position the reference gives its
best logit; each token's gap is how far the served token's reference logit
lies below that best (in logits).  The numbers a cell may compare, as
its traffic file's `limits` name them: the widest gap over every sampled
token (`max_logit_gap`), their mean (`mean_logit_gap`), and the share of
served tokens with a gap at all (`logit_miss_share`).  A greedy server in a precision close enough
to the reference serves the reference's best token or one within rounding
of it; a wrong weight, a stale cache or a dropped layer serves tokens far
below it.

The sample is stratified: the requests are grouped by model and by the
kind of load that served them (every leaf a device hit, a partial reuse,
every leaf over h2d), and drawn round-robin over the groups, so that every
kind the window had is checked.  All requests of a cell are of one length.

`control` is the same comparison with the reference in float8 in the
program's place: at each position, the gap of the token that the float8
reference puts first (`max_control_gap`, `mean_control_gap`,
`control_miss_share`).
"""
from __future__ import annotations

import math
import random
from collections import defaultdict

import torch

import reference
from pbench.traffic import mix


def load_kind(stats) -> str:
    if stats.bytes_h2d == 0:
        return "device_hit"
    if stats.bytes_device_hit == 0:
        return "h2d"
    return "partial"


def sample(served: list, n: int, seed: int) -> list:
    """Up to `n` finished requests, round-robin over (model, load kind)."""
    rng = random.Random(mix(seed, 2))
    groups = defaultdict(list)
    for s in served:
        if not s.failed:
            groups[(s.arrival.model_id, load_kind(s.load[1]))].append(s)
    order = sorted(groups)
    for key in order:
        rng.shuffle(groups[key])
    rng.shuffle(order)
    out = []
    while len(out) < n and any(groups.values()):
        for key in order:
            if groups[key] and len(out) < n:
                out.append(groups[key].pop())
    return out


def _readings(gap: torch.Tensor, prefix: str) -> dict:
    """The numbers the check can compare, of every sampled token's gap."""
    return {f"max_{prefix}gap": float(gap.max()), f"mean_{prefix}gap": float(gap.mean()),
            f"{prefix}miss_share": float((gap > 0).float().mean())}


def references(conf: dict) -> dict:
    """model id -> the reference module its entry in configuration `conf`
    names, loaded; a missing one stops the run, naming the model."""
    out = {}
    for m in conf["models"]:
        module = reference.module_of(m)
        try:
            out[m["id"]] = reference.load(module)
        except ModuleNotFoundError as e:
            raise SystemExit(f"model {m['id']!r} of configuration {conf['name']!r} names the "
                             f"reference {module!r}: {e}") from e
    return out


def gaps(weights: dict, cfgs: dict, picked: list, device, refs: dict, *,
         control: bool = False) -> dict:
    """The reference's readings over the picked requests, each model's
    through its module in `refs` (`references`): of the served tokens' gaps
    (`max_logit_gap`, `mean_logit_gap`, and `logit_miss_share`, the share of
    served tokens that are not the reference's best), and with `control`
    the same of the float8 reference's first tokens (`max_control_gap`,
    ...); also the tokens compared."""
    precisions = ("fp32", "fp8") if control else ("fp32",)
    served_gaps, control_gaps = [], []
    by_model = defaultdict(list)
    for s in picked:
        by_model[s.arrival.model_id].append(s)
    for model_id, reqs in by_model.items():
        seqs, served = [], []
        for s in reqs:
            prompt = s.prompt[0].tolist()
            toks = [int(t) for t in torch.cat([t.reshape(-1) for t in s.tokens]).tolist()]
            S = len(prompt)
            seqs.append((prompt + toks[:-1], S, list(range(S - 1, S - 1 + len(toks)))))
            served.append(toks)
        logits = refs[model_id].forward(weights[model_id], cfgs[model_id], seqs, device=device,
                                        precisions=precisions)
        for i, toks in enumerate(served):
            lg = logits["fp32"][i]
            best = lg.max(-1).values
            idx = torch.as_tensor(toks, device=lg.device)
            served_gaps.append((best - lg.gather(-1, idx[:, None])[:, 0]).cpu())
            if control:
                top = logits["fp8"][i].argmax(-1)
                control_gaps.append((best - lg.gather(-1, top[:, None])[:, 0]).cpu())
        del logits
    if not served_gaps:
        return {"max_logit_gap": math.inf, "mean_logit_gap": math.inf,
                "logit_miss_share": math.inf, "tokens": 0}
    out = _readings(torch.cat(served_gaps), "logit_")
    out["tokens"] = sum(len(g) for g in served_gaps)
    if control:
        out.update(_readings(torch.cat(control_gaps), "control_"))
    return out
