#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing its own lines:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — every CUDA kernel of the path, compiled from ``src/repro_torch/
   csrc`` in parallel (one nvcc per source), with ptxas's resource report;
3. kernels — each kernel's wrapper on card tensors at every GEMM shape the
   main path gives it (full-width AlexNet at batch 1, uncompacted and with
   half of every prunable layer's channels compacted away) plus edge cases,
   held against its plain PyTorch version with the tolerance stated below,
   and timed with CUDA events beside the plain version, one PyTorch call
   computing the same function (``library_ms``) and the card's bound;
4. slice — the paper's int8-quantized, compacted AlexNet (``alexnet_config
   (38)``, 224x224x3, random weights from a seed) served through
   ``repro_torch.serving.connect(plan, backend="local")`` on the card at the
   greedy split, at c=13 (every conv on the edge) and at c=N (every layer
   through the kernel), plus one uncompacted masked plan; the kernel's
   launch count must equal (edge conv+dense layers) x requests, and the
   logits and wire bytes must match the same plan served on the CPU;
5. profile — where one full-width request's device time goes.

It then prints the kernels' JSON line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero without that line; so does a machine without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
REQUESTS = 8
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3
#: bandwidth and the fp32 rate of the CUDA cores (the kernels are fp32)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
#: the TPU kernel each CUDA kernel replaces
REPLACES = {"masked_matmul":
            "src/repro/kernels/masked_matmul/kernel.py:26"}
SOURCES = {"masked_matmul": "src/repro_torch/csrc/masked_matmul.cu"}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean ms of ``reps`` back-to-back calls,
    from CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def gemm_shapes(cfg):
    """(layer, M, K, N) of every conv (im2col) and dense GEMM of one
    batch-1 request through ``cfg``."""
    from repro_torch.models.cnn import layer_shapes
    shapes = layer_shapes(cfg)
    c_in = cfg.input_channels
    out = []
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            c, h, w = shapes[i]
            out.append((f"conv{i}", h * w, c_in * spec.kernel ** 2, c))
            c_in = c
        elif spec.kind == "dense":
            out.append((f"dense{i}", 1, shapes[i - 1][0], spec.features))
    return out


def bound_parts_ms(M: int, K: int, N: int):
    """(bytes ms, operations ms) for the masked GEMM on the card: A, B and
    the mask read once and C written once at the memory rate, against
    2MNK + MN fp32 operations at the fp32 rate. The bound is the larger."""
    nbytes = 4 * (M * K + K * N + N + M * N)
    flops = 2 * M * N * K + M * N
    return 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_FP32_FLOP_S


def check_masked_matmul(cases):
    """Phase 3: kernel against plain version at each (name, M, K, N, mask
    kind); returns the per-case rows."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    with exact_fp32():
        for name, M, K, N, kind in cases:
            a = torch.randn(M, K, device="cuda", generator=gen)
            b = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
            if kind == "ones":
                m = torch.ones(N, device="cuda")
            elif kind == "zeros":
                m = torch.zeros(N, device="cuda")
            else:
                m = (torch.rand(N, device="cuda", generator=gen)
                     < 0.5).float()
            got = masked_matmul(a, b, m)
            torch.cuda.synchronize()
            want = masked_matmul_ref(a, b, m)
            torch.cuda.synchronize()
            # tolerance: two fp32 sums of the same K products in different
            # orders differ by at most K·eps·(|A|@|B|) per element (each
            # errs by at most K·u·sum|a_k b_k|, u = eps/2)
            tol = K * eps * (a.abs() @ b.abs())
            err = (got - want).abs()
            pruned_exact = bool((got[:, m == 0] == 0).all())
            ok = bool((err <= tol).all()) and pruned_exact
            row = {"case": name, "M": M, "K": K, "N": N, "mask": kind,
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "ok": ok,
                   "ms": time_ms(lambda: masked_matmul(a, b, m)),
                   "plain_ms": time_ms(lambda: masked_matmul_ref(a, b, m)),
                   "library_ms": time_ms(lambda: torch.matmul(a, b) * m)}
            row["bytes_ms"], row["ops_ms"] = bound_parts_ms(M, K, N)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] > row["ops_ms"]
                               else "operations")
            print("kernel masked_matmul " + json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"masked_matmul disagrees with its "
                                     f"plain version at {name}: {row}")
            rows.append(row)
    return rows


def half_masks(cfg, params, rng):
    """Keep a random half of each prunable layer's channels."""
    import numpy as np
    from repro_torch.models.cnn import prunable_layers
    masks = {}
    for i in prunable_layers(cfg):
        n = params[f"l{i}"]["b"].shape[0]
        m = np.zeros(n, np.float32)
        m[rng.permutation(n)[:n // 2]] = 1.0
        masks[i] = m
    return masks


def logit_tolerance(plan):
    """-> a function giving, per request image, the elementwise bound on
    |logits(card) - logits(CPU)|.

    Both devices run the same plan with GEMMs and convs that sum in
    different orders, which moves the logits by far less than 1e-3 of the
    largest one (the fp32 part). At an interior split the int8 codec may
    also round one side's boundary element one step (the frame's scale)
    away from the other's; ``cnn_abs_bound`` carries a one-step change of
    every element through the cloud half (the codec part)."""
    import numpy as np
    import torch
    from repro_torch.core.collab.local_runtime import deploy_submodels
    from repro_torch.core.collab.protocol import affine_qparams
    from repro_torch.core.collab.quant import quant_cnn_apply, quantize_params
    from repro_torch.device import exact_fp32
    from repro_torch.models.cnn import cnn_abs_bound, masks_to, oihw_params

    def fp32_part(logits):
        return 1e-3 * max(1.0, float(np.abs(logits).max()))

    n = len(plan.cfg.layers)
    if plan.split in (0, n) or plan.codec != "int8":
        return lambda image, logits: fp32_part(logits)
    dev = torch.device("cuda")
    dparams, dcfg, dmasks = deploy_submodels(plan.params, plan.cfg,
                                             plan.masks, plan.compact)
    dparams = {k: {leaf: t.to(dev) for leaf, t in v.items()}
               for k, v in dparams.items()}
    masks = masks_to(dmasks, dev)
    q = quantize_params(dparams, dcfg, plan.quant)
    tparams = oihw_params(dparams, dcfg)

    def tolerance(image, logits):
        with torch.inference_mode(), exact_fp32():
            feat = quant_cnn_apply(q, dcfg, torch.from_numpy(image).to(dev),
                                   masks=masks, stop_layer=plan.split,
                                   backend="ref")
            step, _ = affine_qparams(float(feat.min()), float(feat.max()),
                                     255)
            codec = cnn_abs_bound(tparams, dcfg, torch.full_like(feat, step),
                                  masks=masks, start_layer=plan.split)
        return fp32_part(logits) + codec.cpu().numpy()
    return tolerance


def serve_path(label, plan, images, edge_gemms):
    """Phase 4 for one plan: serve on the card with the launch counter
    read around the run, then the same requests on the CPU."""
    import numpy as np
    from repro_torch import serving
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    sess = serving.connect(plan, backend="local")        # the card
    masked_matmul.launches = 0
    got = sess.infer_many(images)
    launches = masked_matmul.launches
    want_launches = edge_gemms * len(images)
    cpu = serving.connect(plan, backend="local", device="cpu")
    want = cpu.infer_many(images)
    tolerance = logit_tolerance(plan)
    worst = 0.0
    for img, g, w in zip(images, got, want):
        lg, lw = g["logits"], w["logits"]
        if not (lg.shape == lw.shape and np.isfinite(lg).all()):
            raise AssertionError(f"{label}: bad logits {lg.shape}")
        if g["tx_bytes"] != w["tx_bytes"]:
            raise AssertionError(f"{label}: tx_bytes {g['tx_bytes']} on "
                                 f"the card, {w['tx_bytes']} on the CPU")
        tol = tolerance(img, lw)
        gap = np.abs(lg - lw)
        worst = max(worst, float((gap / tol).max()))
        if not (gap <= tol).all() or \
                lg.argmax(-1).tolist() != lw.argmax(-1).tolist():
            raise AssertionError(f"{label}: logits differ from the CPU "
                                 f"path by {gap.max()} (tolerance "
                                 f"{np.min(tol)})")
    if launches != want_launches:
        raise AssertionError(f"{label}: masked_matmul launched {launches} "
                             f"times, expected {want_launches}")
    edge_ms = [1e3 * r["wallclock"]["edge"] for r in got]
    cloud_ms = [1e3 * r["wallclock"]["cloud"] for r in got]
    row = {"path": label, "split": plan.split,
           "n_layers": len(plan.cfg.layers), "compact": plan.compact,
           "requests": len(images), "launches": launches,
           "tx_bytes": got[0]["tx_bytes"],
           "edge_ms": edge_ms, "cloud_ms": cloud_ms,
           "edge_ms_first": edge_ms[0],
           "edge_ms_median": statistics.median(edge_ms[1:]),
           "cloud_ms_median": statistics.median(cloud_ms[1:]),
           "t_edge_model_s": got[0]["t_edge"],
           "t_upstream_model_s": got[0]["t_upstream"],
           "max_gap_over_tol": worst}
    print("slice " + json.dumps(row), flush=True)
    return row


def edge_gemm_count(plan) -> int:
    return sum(1 for s in plan.cfg.layers[:plan.split]
               if s.kind in ("conv", "dense"))


def profile_request(plan, image):
    """Phase 5: device time by kernel for one request, against the
    request's unprofiled wall-clock (after warm-up; the first profiler
    pass, which pays the tracer's start-up, is discarded)."""
    import torch
    from repro_torch import serving
    sess = serving.connect(plan, backend="local")
    sess.infer(image)
    t0 = time.perf_counter()
    sess.infer(image)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            sess.infer(image)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    print("profile " + json.dumps({
        "split": plan.split, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.device_time_total / 1e3} for e in top]}),
        flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "card", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch import serving
    from repro_torch.kernels import build
    from repro_torch.models.cnn import (alexnet_config, compact_cnn_config,
                                        init_cnn_params)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build {sorted(logs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}", flush=True)

    # 3. kernels against their plain versions
    cfg = alexnet_config(38)
    params = init_cnn_params(SEED, cfg)
    rng = np.random.default_rng(SEED + 1)
    masks = half_masks(cfg, params, rng)
    full = [(f"{n} full", M, K, N, "partial")
            for n, M, K, N in gemm_shapes(cfg)]
    compacted = [(f"{n} compact", M, K, N, "ones")
                 for n, M, K, N in gemm_shapes(compact_cnn_config(cfg, masks))]
    edge_cases = [("ragged", 77, 29, 45, "partial"),
                  ("m1", 1, 300, 50, "partial"),
                  ("all_zero_mask", 64, 128, 96, "zeros"),
                  ("partial_mask", 512, 256, 192, "partial")]
    rows = check_masked_matmul(full + compacted + edge_cases)

    # 4. the slice at full width
    images = [rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
              for _ in range(REQUESTS)]
    quant = serving.QuantPolicy(weight_bits=8)
    n = len(cfg.layers)
    plans = {}
    for label, split, compact in (("greedy", None, True),
                                  ("c13", 13, True),
                                  ("cN", n, True),
                                  ("masked_cN", n, False)):
        plans[label] = serving.DeploymentPlan.from_args(
            params, cfg, split, masks=masks, compact=compact, codec="int8",
            quant=quant)
    launches = sum(serve_path(label, plan, images,
                              edge_gemm_count(plan))["launches"]
                   for label, plan in plans.items())

    # 5. where one full-width request's device time goes
    profile_request(plans["greedy"], images[0])
    profile_request(plans["c13"], images[0])

    # times of the kernel line: the sum over the GEMMs of one c=N request
    # of the compacted plan (each conv and dense layer once)
    main_rows = [r for r in rows if r["case"].endswith(" compact")]
    total = {k: sum(r[k] for r in main_rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "bytes_ms", "ops_ms")}
    kernels = [{"name": "masked_matmul", "route": "cuda",
                "source": SOURCES["masked_matmul"],
                "replaces": REPLACES["masked_matmul"],
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"],
                "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                             else "operations"),
                "library_ms": total["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
