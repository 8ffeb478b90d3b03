"""Fine-tuning after pruning: the port's CNN train step (SGD with
momentum, the masks applied, fp32 with TF32 off) on batches drawn
cyclically from a pool of images made in set-up from the seed.

Traffic keys: ``batch`` (images a step), ``pool`` (images, a whole
number of batches), ``lr``, ``momentum``, ``checked_steps`` (the steps
the check follows with the reference, twice: the first steps, run in
set-up, and as many more once the window has closed, from the state the
window left; each time through the same step object, on batches that all
differ), ``trace_seconds``.
The port's step takes the batch as numpy arrays and copies it to the
card itself; the pool is numpy over pinned host memory, as a data
loader with ``pin_memory`` hands it.

Training samples a second are the images of the steps the window
completed over the window, from its start to the synchronize after its
last step.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from perfbench.lib import cnn, counts, seeded
from perfbench.lib.peaks import FLOP_S
from perfbench.lib.trace import span
from perfbench.references import cnn as ref


def _clone(tree):
    return {k: {n: t.detach().clone() for n, t in v.items()}
            for k, v in tree.items()}


def setup(run):
    from repro_torch.core.pipeline import make_train_step
    from repro_torch.optim import make_optimizer
    t = run.traffic
    model = cnn.build(run.config, run.seed, run.device)
    images, labels = seeded.leaf_images(
        t["pool"], run.config["input_hw"][0], run.config["num_classes"],
        run.seed, run.device)
    lr = t["lr"]
    opt = make_optimizer("sgd", lambda step: lr, momentum=t["momentum"])
    state = {"model": model, "images": images, "labels": labels,
             "host": _pinned(images), "host_labels": _pinned(labels),
             "params": model.params,
             "opt": opt.init(model.params), "losses": [], "events": [],
             "step": make_train_step(model.pcfg, opt, masks=model.masks,
                                     device=run.device), "k": 0}
    state["checked"] = {"set-up": checked_steps(state, run)}
    return state


def checked_steps(state, run) -> dict:
    """``checked_steps`` steps from the state as it stands: the start
    (parameters, momentum, batch index) and what the program made of it
    (each loss, the first gradient as the optimizer got it, the
    parameters after the steps)."""
    mu = run.traffic["momentum"]
    out = {"p0": _clone(state["params"]), "m0": _clone(state["opt"]["mom"]),
           "k0": state["k"], "losses": []}
    for j in range(run.traffic["checked_steps"]):
        train_step(state, run)
        out["losses"].append(float(state["losses"][-1]))
        if j == 0:       # momentum' = mu * momentum + gradient
            out["g1"] = {k: {n: m - mu * out["m0"][k][n]
                             for n, m in v.items()}
                         for k, v in state["opt"]["mom"].items()}
    out["p"] = _clone(state["params"])
    return out


def after_window(state, run):
    state["checked"]["window"] = checked_steps(state, run)


def _pinned(t: torch.Tensor):
    """A numpy view of a copy of ``t`` in pinned host memory (plain host
    memory on a machine without a card)."""
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    host.copy_(t)
    return host.numpy()


def batch(state, run, k: int) -> dict:
    B = run.traffic["batch"]
    lo = (k * B) % state["host"].shape[0]
    return {"image": state["host"][lo:lo + B],
            "label": state["host_labels"][lo:lo + B]}


def train_step(state, run):
    with span("train_step"):
        state["params"], state["opt"], loss = state["step"](
            state["params"], state["opt"], batch(state, run, state["k"]))
    state["losses"].append(loss)
    state["k"] += 1


def window(state, run):
    timed = run.device != "cpu"
    k0 = state["k"]
    t0 = time.perf_counter()
    while time.perf_counter() < run.deadline:
        train_step(state, run)
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            state["events"].append(ev)
    run.sync()
    state["window_s"] = time.perf_counter() - t0
    state["steps"] = state["k"] - k0
    run.attempted = state["steps"] * run.traffic["batch"]


def end_to_end(state, run):
    return {"train_samples_per_s":
            state["steps"] * run.traffic["batch"] / state["window_s"]}


def per_layer(state, run):
    model = state["model"]
    gemms = counts.cnn_kept_layers(model.layers, model.kept())
    # forward, and a backward of twice its operations
    flops = 3 * counts.cnn_forward_flops(gemms) * run.traffic["batch"]
    run.record["peak_s"] = state["steps"] * flops / FLOP_S["float32"]
    ev = state["events"]
    if len(ev) > 1:
        run.record["train_step_ms"] = statistics.median(
            [a.elapsed_time(b) for a, b in zip(ev, ev[1:])])


def free(state):
    for key in ("step", "opt", "params", "events", "losses"):
        state.pop(key, None)


def _reference(state, run, start: dict, tf32: bool = False,
               half: bool = False):
    """The checked steps by the plain reference from the same start:
    (losses, first gradient, parameters after the steps); ``tf32``: with
    TF32 on; ``half``: on the first half of each batch only (a fault)."""
    model, t = state["model"], run.traffic
    layers, masks = model.layers, model.masks
    p = {k: t_.clone() for k, t_ in ref.flat(start["p0"]).items()}
    mom = {k: t_.clone() for k, t_ in ref.flat(start["m0"]).items()}
    losses, g1 = [], None
    for j in range(t["checked_steps"]):
        B = t["batch"]
        lo = ((start["k0"] + j) * B) % state["images"].shape[0]
        n = B // 2 if half else B
        x, y = state["images"][lo:lo + n], state["labels"][lo:lo + n]
        loss, g = ref.loss_and_grads(layers, p, masks, x, y, tf32=tf32)
        losses.append(float(loss))
        if g1 is None:
            g1 = g
        with torch.no_grad():
            for leaf in p:
                mom[leaf] = t["momentum"] * mom[leaf] + g[leaf]
                p[leaf] = p[leaf] - t["lr"] * mom[leaf]
    return losses, g1, p


def check(state, run, control=None):
    """Twice, for the first steps and for the steps from the state the
    window left (the second set of names starts with ``window_``): each
    checked step's loss, the first gradient (worked out from the momentum
    before and after one step) and the parameters' change over the checked
    steps, against the reference's from the same start. The loss by its
    gap over the larger of the reference's loss and its first step's in
    set-up; each leaf's gradient by the gap of its norm to the reference's
    over the larger of that norm and the median leaf's (in set-up or now,
    whichever is larger), at its worst leaf: a state the window has
    trained far has losses and gradients all but zero, where a relative
    gap reads the round-off of the last digits (seed to seed from 1e-7 to
    1e-2 on the card). Each leaf's change by the gap of its norm over the
    larger of that norm and the median leaf's (in set-up or now), at its
    median leaf (the worst leaf's change spreads on the card as far
    between two runs of the reference itself: its backward's sums are not
    in a fixed order); a window that leaves the network dead, no unit
    active, decays the momentum to zero and moves no leaf at all.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out. A start, a loss or a gradient that is not
    finite, on either side, reads ``NOT_FINITE`` in all three numbers
    (a crash would print no result, and a NaN compares as no number).
    With ``control="precision"`` the reference with TF32 on stands in for
    the program, with ``"half_batch"`` the reference on half of each
    batch."""
    out, scale = {}, None
    for prefix, name in (("", "set-up"), ("window_", "window")):
        numbers, scale = _compare(state, run, state["checked"][name],
                                  control, scale)
        out.update({prefix + k: v for k, v in numbers.items()})
    return out


#: what each number reads where a start, loss, gradient or end state is
#: not finite
NOT_FINITE = 1e30


def _finite(losses, *trees) -> bool:
    return (all(math.isfinite(v) for v in losses)
            and all(bool(torch.isfinite(t).all())
                    for tree in trees for t in tree.values()))


def _compare(state, run, start: dict, control, scale=None):
    """The three numbers from ``start``, and the scales of the loss and the
    gradient that they are measured against (``scale``: the set-up's)."""
    losses, g1, p = _reference(state, run, start)
    if control:
        got_losses, got_g1, got_p = _reference(
            state, run, start, tf32=control == "precision",
            half=control == "half_batch")
    else:
        got_losses = start["losses"]
        got_g1, got_p = ref.flat(start["g1"]), ref.flat(start["p"])
    p0 = ref.flat(start["p0"])
    if not _finite(losses + got_losses, g1, got_g1, p0, p, got_p):
        return dict.fromkeys(("loss_gap", "grad_gap", "update_gap"),
                             NOT_FINITE), scale
    norms = {n: float(g.norm()) for n, g in g1.items()}
    med = statistics.median(norms.values())
    live = [n for n in g1 if norms[n] >= 1e-3 * med]
    change = {n: p[n] - p0[n] for n in live}
    scale = scale or {"loss": abs(losses[0]), "grad": med,
                      "update": statistics.median(
                          float(c.norm()) for c in change.values())}
    return {"loss_gap": max(abs(a - b) / max(abs(b), scale["loss"])
                            for a, b in zip(got_losses, losses)),
            "grad_gap": max(_leaf_gaps(got_g1, g1, live, scale["grad"])),
            "update_gap": statistics.median(_leaf_gaps(
                {n: got_p[n] - p0[n] for n in live}, change, live,
                scale["update"]))}, scale


def _leaf_gaps(got, want, names, floor: float = 0.0) -> list:
    """Each leaf's gap of norms over the larger of the reference's norm and
    the median leaf's (at least ``floor``)."""
    ref_norms = {n: float(want[n].norm()) for n in names}
    med = max(statistics.median(ref_norms.values()), floor)
    return [abs(float(got[n].norm()) - ref_norms[n]) / max(ref_norms[n], med)
            for n in names]
