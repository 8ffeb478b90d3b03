"""Offline batch generation: every row's prompt is prefilled in set-up
by the port's prefill step (the cache the traffic needs), then the whole
batch decodes greedily, one token a row a step, for the whole window.

Traffic keys: ``batch`` (rows), ``prompt`` (tokens a row, drawn from the
seed), ``max_len`` (the cache's slots a row), ``prefill_rows`` (rows a
prefill call in set-up, each call's cache put into the batch's),
``trace_seconds``. Where the rows reach the end of the cache before the
window closes, the batch starts its answers again from the prompts' cache
(its positions set back to the prompt's end; the slots after them are
written anew), so the window keeps the cache between ``prompt`` and
``max_len`` full however fast the step is. The cell's
``workloads/<cell>.json`` gives ``sample_rows``: how many rows the check
runs the reference over, prompt and every generated token of the last
pass and of the first whole one.

Output tokens a second are all the tokens the window's steps generated
over the window, from its start to the synchronize after its last step.
"""
from __future__ import annotations

import statistics
import time

import torch

from perfbench.lib import counts, lm, seeded
from perfbench.lib.peaks import FLOP_S
from perfbench.lib.trace import span
from perfbench.references import transformer as ref


def setup(run):
    t = run.traffic
    model = lm.build(run.config, run.seed, run.device)
    B, S, max_len = t["batch"], t["prompt"], t["max_len"]
    prompts = seeded.token_batches(model.m["V"], B, [S], run.seed,
                                   run.device)[0]
    gen = torch.zeros((B, max_len - S), dtype=torch.long, device=run.device)
    state = {"model": model, "prompts": prompts, "gen": gen,
             "decode": model.decode_step(run.device), "steps": 0,
             "events": [], "fed": [], "first_pass": None}
    state["cache"] = prefill(model, prompts, max_len, t["prefill_rows"],
                             gen, run.device)
    state["n"] = 1
    step(state)                                  # the step's shapes, once
    return state


def prefill(model, prompts, max_len: int, rows: int, gen, device):
    """The batch's cache, ``rows`` prompts a call of the port's prefill
    step; each call's first tokens into ``gen[:, 0]``."""
    from repro_torch.models.transformer import init_cache
    B = prompts.shape[0]
    step = model.prefill_step(max_len, device)
    cache = init_cache(model.pcfg, B, max_len, device)
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        with span("prefill"):
            lg, part = step(model.params, {"tokens": prompts[lo:hi]})
        gen[lo:hi, 0] = lg.argmax(-1)
        for dst, src in zip(cache["runs"], part["runs"]):
            for d, s in zip(dst, src):
                d[:, lo:hi] = s
        cache["pos"][lo:hi] = part["pos"]
        del part
    return cache


def step(state):
    """One decode step of every row; its token into ``gen``."""
    n, model = state["n"], state["model"]
    with span("decode"):
        lg, state["cache"] = state["decode"](
            model.params, state["cache"], state["gen"][:, n - 1:n])
        state["gen"][:, n] = lg.argmax(-1)
    state["n"] = n + 1


def rewind(state):
    """The rows at the end of the cache: keep the first whole pass's
    tokens and start the answers again from the prompts' cache."""
    if state["first_pass"] is None:
        state["first_pass"] = state["gen"].clone()
    pos = state["cache"]["pos"]
    state["cache"] = dict(state["cache"], pos=torch.full_like(
        pos, state["prompts"].shape[1]))
    state["n"] = 1


def window(state, run):
    timed = run.device != "cpu"
    t0 = time.perf_counter()
    cap = state["gen"].shape[1]
    while time.perf_counter() < run.deadline:
        if state["n"] == cap:
            rewind(state)
        state["fed"].append(state["n"])
        step(state)
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            state["events"].append(ev)
    run.sync()
    state["window_s"] = time.perf_counter() - t0
    state["steps"] = len(state["fed"])
    run.attempted = state["gen"].shape[0]


def end_to_end(state, run):
    B = state["gen"].shape[0]
    return {"output_tokens_per_s": B * state["steps"] / state["window_s"]}


def per_layer(state, run):
    model, t = state["model"], run.traffic
    m, k, B = model.m, model.k, t["batch"]
    flops, mm = 0.0, 0.0
    for n in state["fed"]:
        # the step writing gen[:, n] fed the token at position S + n - 1
        flops += counts.lm_decode_flops(m, k, B, B * (t["prompt"] + n))
        mm += counts.lm_decode_kernels(m, k, B)["masked_matmul"]
    ev = state["events"]
    run.record.update(peak_s=flops / FLOP_S["bfloat16"],
                      kernels_least_s={"masked_matmul": mm})
    if len(ev) > 1:
        run.record["decode_step_ms"] = statistics.median(
            [a.elapsed_time(b) for a, b in zip(ev, ev[1:])])


def free(state):
    for key in ("cache", "decode", "events"):
        state.pop(key, None)


def check(state, run, control=None):
    """The widest gap, over every generated token of the sampled rows, between
    the reference's best logit and the generated token's; with
    ``control="precision"``, that of the token the fp8-weight reference
    puts first instead. The tokens are the last pass's and, where the
    window went round the cache, the first whole pass's."""
    model, S = state["model"], run.traffic["prompt"]
    gen = torch.Generator().manual_seed(seeded.sub_seed(run.seed, "check"))
    rows = torch.randperm(state["gen"].shape[0], generator=gen)
    passes = [(state["gen"], state["n"])]
    if state["first_pass"] is not None:
        passes.append((state["first_pass"], state["gen"].shape[1]))
    widest = 0.0
    for r in rows[:run.limits["sample_rows"]].tolist():
        for out, n in passes:
            chosen = out[r:r + 1, :n]
            tokens = torch.cat([state["prompts"][r:r + 1], chosen[:, :-1]],
                               1)
            g = ref.served_gaps(model.w, model.masks, model.m, tokens,
                                range(S - 1, S - 1 + n), chosen, control)
            widest = max(widest, float(g.max()))
    return {"max_gap": widest}
