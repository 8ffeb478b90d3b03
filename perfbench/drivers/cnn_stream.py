"""A camera or drone uploading bursts of leaf photos to the port's
streaming session (edge ∥ link ∥ cloud threads), closed loop: the next
burst is sent when the last one's logits are back.

Traffic keys: ``burst`` (images an ``infer_many`` call), ``pool``
(distinct images made in set-up from the seed, drawn cyclically),
``microbatch`` and ``queue_depth`` (the session's), ``trace_seconds``.
The deployment (split, codec, edge weight bits, compaction) is the
configuration's. The link's modelled time is charged, not slept.

Images a second are the images whose logits came back in the window over
the window. The check compares every image of the window with the plain
reference, frame by frame as the session grouped them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import cnn, counts, seeded
from perfbench.lib.trace import span
from perfbench.references import cnn as ref


def setup(run):
    from repro_torch import serving
    t, dep = run.traffic, run.config["deployment"]
    model = cnn.build(run.config, run.seed, run.device)
    hw = run.config["input_hw"][0]
    images, _ = seeded.leaf_images(t["pool"], hw, run.config["num_classes"],
                                   run.seed, run.device)
    host = images.cpu().numpy()
    plan = serving.DeploymentPlan.from_args(
        model.params, model.pcfg, dep["split"], masks=model.masks,
        compact=dep["compact"], codec=dep["codec"],
        quant=serving.QuantPolicy(weight_bits=dep["edge_weight_bits"],
                                  per_channel=dep["per_channel"]))
    sess = serving.connect(plan, backend="streaming", device=run.device,
                           realtime_channel=False,
                           microbatch=t["microbatch"],
                           queue_depth=t["queue_depth"])
    sess.__enter__()
    state = {"model": model, "images": images, "sess": sess, "bursts": [],
             "pool": [host[i:i + 1] for i in range(t["pool"])]}
    burst(state, run, 0)                        # every shape, once
    state["bursts"].clear()
    return state


def burst(state, run, start: int):
    """One ``infer_many`` of ``burst`` images from pool index ``start``."""
    n, pool = run.traffic["burst"], state["pool"]
    idx = [(start + j) % len(pool) for j in range(n)]
    with span("stream"):
        outs = state["sess"].infer_many([pool[i] for i in idx])
    rep = state["sess"].last_report
    state["bursts"].append({
        "idx": idx, "logits": np.concatenate([o["logits"] for o in outs]),
        "tx": [o["tx_bytes"] for o in outs],
        "frames": [r["frame_n"] for r in rep.results],
        "edge_s": rep.stages["edge"].busy_s,
        "cloud_s": rep.stages["cloud"].busy_s})
    return start + n


def window(state, run):
    t0 = time.perf_counter()
    nxt = 0
    while time.perf_counter() < run.deadline:
        nxt = burst(state, run, nxt)
        run.attempted += run.traffic["burst"]
    state["window_s"] = time.perf_counter() - t0


def _images(state):
    return sum(len(b["idx"]) for b in state["bursts"])


def end_to_end(state, run):
    return {"images_per_s": _images(state) / state["window_s"]}


def per_layer(state, run):
    model, split = state["model"], run.config["deployment"]["split"]
    gemms = counts.cnn_kept_layers(model.layers, model.kept())
    edge = [g for g in gemms if g["layer"] < split]
    cloud = [g for g in gemms if g["layer"] >= split]
    n = _images(state)
    run.record.update(
        peak_s=n * counts.mixed_least_s(
            {"int8": counts.cnn_forward_flops(edge),
             "float32": counts.cnn_forward_flops(cloud)}),
        kernels_least_s={"masked_matmul": n * sum(counts.q8_splitk(g)
                                                  for g in edge)},
        edge_stage_ms=1e3 * sum(b["edge_s"] for b in state["bursts"]) / n,
        cloud_stage_ms=1e3 * sum(b["cloud_s"] for b in state["bursts"]) / n)


def free(state):
    sess = state.pop("sess", None)
    if sess is not None:
        sess.__exit__(None, None, None)


def check(state, run, control=None):
    """Every image of the window: the largest logit gap to the reference
    (over the image's largest reference logit, at least 1), and the
    largest gap of its share of its frame's wire bytes (the session
    states a request's share as a whole number of bytes, rounded down).
    With ``control="precision"`` the reference's own edge at the next
    bit width below (4) stands in for the program."""
    model, dep = state["model"], run.config["deployment"]
    layers, split = model.layers, dep["split"]
    cl = ref.compact(layers, model.w, model.masks)
    feats = ref.run(ref.quantized_edge(cl, layers, split,
                                       dep["edge_weight_levels"]),
                    layers, state["images"], 0, split)
    low = (ref.run(ref.quantized_edge(cl, layers, split, 15), layers,
                   state["images"], 0, split)
           if control == "precision" else None)
    worst_logit, worst_tx = 0.0, 0.0
    for b in state["bursts"]:
        frames = _frames(b["frames"])
        if frames is None:
            return {"logit_gap": float("inf"), "tx_bytes_gap": float("inf")}
        idx = torch.as_tensor(b["idx"], device=feats.device)
        want = _cloud(cl, layers, split, feats[idx], frames, dep)
        if low is not None:
            got = _cloud(cl, layers, split, low[idx], frames, dep)
        else:
            got = torch.as_tensor(b["logits"], device=want.device)
        scale = want.abs().amax(1).clamp_min(1.0)
        worst_logit = max(worst_logit, float(
            ((got - want).abs().amax(1) / scale).max()))
        for (lo, hi) in frames:
            nb = ref.frame_bytes(tuple(feats.shape[1:]), hi - lo) // (hi - lo)
            worst_tx = max(worst_tx, max(abs(t - nb) for t in b["tx"][lo:hi]))
    return {"logit_gap": worst_logit, "tx_bytes_gap": worst_tx}


def _frames(frame_n):
    """[(lo, hi)] blocks of consecutive images that shared a frame, from
    each image's ``frame_n``; None where they do not tile the burst."""
    out, i = [], 0
    while i < len(frame_n):
        n = frame_n[i]
        if n < 1 or any(f != n for f in frame_n[i:i + n]) \
                or i + n > len(frame_n):
            return None
        out.append((i, i + n))
        i += n
    return out


def _cloud(cl, layers, split, feats, frames, dep):
    """Each frame's features through the codec, then the cloud half."""
    wire = torch.cat([ref.affine_codes(feats[lo:hi], dep["codec_levels"])
                      for lo, hi in frames])
    return ref.run(cl, layers, wire, split, len(layers))
