"""Closed loop of request batches replaying a fixed cycle of prompt
lengths: each batch is prefilled, then decoded greedily for the rest of
its answer, and the next batch is sent when it is done.

Traffic keys: ``batch`` (rows a batch), ``lengths`` (the cycle of prompt
lengths, the same on every seed; the seed draws the token ids),
``new_tokens`` (greedy tokens a request: the first from the prefill, the
rest from decode steps), ``pool_cycles`` (cycles of prompts drawn in
set-up; the window wraps round them), ``trace_seconds``. The cell's
``workloads/<cell>.json`` gives ``sample_requests``: how many finished
requests (rows of the window's batches) the check runs the reference
over, one of the longest prompts always among them.

The time to first token of a request is its batch's, from the call of
the prefill step to the first token on the host after a synchronize.
"""
from __future__ import annotations

import statistics
import time

import torch

from perfbench.lib import counts, lm, seeded, stats
from perfbench.lib.peaks import FLOP_S
from perfbench.lib.trace import span
from perfbench.references import transformer as ref


def setup(run):
    t = run.traffic
    model = lm.build(run.config, run.seed, run.device)
    lengths = list(t["lengths"]) * t["pool_cycles"]
    pool = seeded.token_batches(model.m["V"], t["batch"], lengths, run.seed,
                                run.device)
    state = {"model": model, "pool": pool, "records": [],
             "prefill": {S: model.prefill_step(S + t["new_tokens"],
                                               run.device)
                         for S in t["lengths"]},
             "decode": model.decode_step(run.device)}
    for toks in pool[:len(t["lengths"])]:       # every shape, once
        serve(state, run, toks)
    return state


def serve(state, run, toks):
    """One batch: (served tokens (B, new_tokens), seconds to the first)."""
    model = state["model"]
    t0 = time.perf_counter()
    with span("prefill"):
        lg, cache = state["prefill"][toks.shape[1]](model.params,
                                                    {"tokens": toks})
        tok = lg.argmax(-1, keepdim=True)
    run.sync()
    ttft = time.perf_counter() - t0
    out = [tok]
    for _ in range(run.traffic["new_tokens"] - 1):
        with span("decode"):
            lg, cache = state["decode"](model.params, cache, tok)
            tok = lg.argmax(-1, keepdim=True)
        out.append(tok)
    run.sync()
    return torch.cat(out, 1), ttft


def window(state, run):
    pool, records = state["pool"], state["records"]
    i = 0
    while time.perf_counter() < run.deadline:
        served, ttft = serve(state, run, pool[i % len(pool)])
        records.append({"prompt": i % len(pool), "served": served,
                        "ttft_s": ttft})
        run.attempted += served.shape[0]
        i += 1


def _ttfts_ms(state):
    return [1e3 * r["ttft_s"] for r in state["records"]
            for _ in range(r["served"].shape[0])]


def end_to_end(state, run):
    return {"ttft_p95_ms": stats.percentile(_ttfts_ms(state), 95)}


def per_layer(state, run):
    """The work of the traced window, counted from the batches it ran."""
    model, t = state["model"], run.traffic
    m, k = model.m, model.k
    flops, kern = 0.0, {"masked_matmul": 0.0, "flash_attention": 0.0}
    for r in state["records"]:
        B, S = state["pool"][r["prompt"]].shape
        flops += counts.lm_prefill_flops(m, k, B, S)
        for name, s in counts.lm_prefill_kernels(m, k, B, S).items():
            kern[name] += s
        for j in range(1, t["new_tokens"]):
            flops += counts.lm_decode_flops(m, k, B, B * (S + j))
            kern["masked_matmul"] += counts.lm_decode_kernels(
                m, k, B)["masked_matmul"]
    run.record.update(
        peak_s=flops / FLOP_S["bfloat16"], kernels_least_s=kern,
        prefill_call_ms=statistics.median([1e3 * r["ttft_s"]
                                      for r in state["records"]]))


def free(state):
    for key in ("prefill", "decode"):
        state.pop(key, None)


def check(state, run, control=None):
    """The widest gap, over the sampled requests' served tokens, between the
    reference's best logit and the served token's; with
    ``control="precision"``, that of the token the fp8-weight reference
    puts first instead. The sampled rows of one batch go through the
    reference together."""
    model = state["model"]
    widest = 0.0
    for r, rows in sample(state, run):
        prompt = state["pool"][r["prompt"]][rows]
        served = r["served"][rows]
        S, n = prompt.shape[1], served.shape[1]
        tokens = torch.cat([prompt, served[:, :-1]], 1)
        g = ref.served_gaps(model.w, model.masks, model.m, tokens,
                            range(S - 1, S - 1 + n), served, control)
        widest = max(widest, float(g.max()))
    return {"max_gap": widest}


def sample(state, run):
    """``sample_requests`` finished requests drawn from the seed, a row of
    one of the longest prompts always among them: [(batch's record, its
    sampled rows)]."""
    records = state["records"]
    gen = torch.Generator().manual_seed(seeded.sub_seed(run.seed, "check"))
    rows = [(i, j) for i, r in enumerate(records)
            for j in range(r["served"].shape[0])]
    order = [rows[i] for i in torch.randperm(len(rows),
                                             generator=gen).tolist()]

    def length(i):
        return state["pool"][records[i]["prompt"]].shape[1]
    longest = max(length(i) for i, _ in rows)
    first = next(x for x in order if length(x[0]) == longest)
    picked = [first] + [x for x in order if x != first]
    chosen: dict = {}
    for i, j in picked[:run.limits["sample_requests"]]:
        chosen.setdefault(i, []).append(j)
    return [(records[i], sorted(js)) for i, js in sorted(chosen.items())]
