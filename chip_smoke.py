#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # from the repository root; one card
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels

Phases, each printing its own lines:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — every CUDA kernel of the paths, compiled from ``src/repro_torch/
   csrc`` in parallel (one nvcc per source), with ptxas's resource report;
3. kernels — each kernel's wrapper on card tensors at every shape the main
   paths give it, plus edge cases, held against its plain PyTorch version
   with the tolerance stated beside it, and timed with CUDA events beside
   the plain version, one PyTorch call computing the same function
   (``library_ms``) and the card's bound: the fp32 ``masked_matmul`` at
   every GEMM of full-width AlexNet (uncompacted and with half of every
   prunable layer's channels compacted away); the bf16 ``masked_matmul`` at
   Qwen2-7B's FFN up/gate shapes (M = 2048 and 2000 in prefill, 1 and 2 in
   decode; K = 3584; N = 18944; half the columns masked); ``rmsnorm`` at
   2048 and 2000 rows of 3584 (R1's and R2's prefill) and 1000, bf16 and
   fp32, offsets 0 and 1, and at 1 and 2 rows (decode); ``flash_attention`` at (B=1,
   S=2048) and (B=2, S=1000) with 28/4 heads of 128, causal, plus windowed,
   non-causal, fp32, head-dim 64 and ragged (S=77) cases;
4. slice (AlexNet) — the paper's int8-quantized, compacted AlexNet
   (``alexnet_config(38)``, 224x224x3, random weights from a seed) served
   through ``repro_torch.serving.connect(plan, backend="local")`` on the
   card at the greedy split, at c=13 (every conv on the edge) and at c=N
   (every layer through the kernel), plus one uncompacted masked plan; the
   kernel's launch count must equal (edge conv+dense layers) x requests, and
   the logits and wire bytes must match the same plan served on the CPU;
5. profile (AlexNet) — where one full-width request's device time goes;
6. slice (Qwen2-7B) — the pruned dense transformer at full width and depth
   (``configs/qwen2_7b.CONFIG``: 28 layers, d_model 3584, 28/4 heads, d_ff
   18944, vocab 152064, bf16; random weights from a seeded CUDA generator;
   masks from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit)
   serving two requests through ``launch.steps.make_prefill_step`` and 16
   greedy ``make_decode_step`` steps each: R1 (B=1, S=2048) and R2 (B=2,
   S=1000). The launch counts must be 57 rmsnorm and 56 masked_matmul per
   forward step and 28 flash_attention per prefill. The same requests run
   through the plain versions on the card in bf16 and in fp32 (teacher-
   forced with the kernel path's tokens); every logit row of the kernel
   path must lie within twice the bf16 plain run's distance from the fp32
   run, plus one bf16 spacing of the largest logit;
7. profile (Qwen2-7B) — where one R1 prefill's and one decode step's device
   time goes.

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
#: bandwidth, the fp32 rate of the CUDA cores and the dense bf16 rate of
#: the tensor cores; a bound takes the peak of its inputs' type
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
#: the TPU kernel each CUDA kernel replaces
REPLACES = {"masked_matmul": "src/repro/kernels/masked_matmul/kernel.py:26",
            "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:20",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:38"}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
#: bf16 keeps 8 significant bits: two roundings of nearby fp32 values to
#: bf16 differ by at most their gap plus 2**-7 of the value
BF16_SPACING = 2.0 ** -7
#: the transformer requests: (label, batch, prompt length); 16 decode steps
TRANSFORMER_REQUESTS = (("R1", 1, 2048), ("R2", 2, 1000))
DECODE_STEPS = 16


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean ms of ``reps`` back-to-back calls,
    from CUDA events after a warm-up. A call slower than 2.5 ms takes fewer
    reps (at least 3), so that a round lasts about 50 ms."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(3, min(reps, int(50.0 / max(start.elapsed_time(stop), 1e-3))))
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


def set_bound(row, nbytes: float, flops: float, peak_flop_s: float):
    """Add ``bytes_ms``, ``ops_ms``, ``bound_ms`` (the larger) and
    ``bound_by`` to ``row``: the bytes the function must move at the memory
    rate against its operations at the peak of its inputs' type."""
    row["bytes_ms"] = 1e3 * nbytes / PEAK_BYTES_S
    row["ops_ms"] = 1e3 * flops / peak_flop_s
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] > row["ops_ms"]
                       else "operations")
    return row


def masked_matmul_bound(row, M: int, K: int, N: int, kept: int,
                        itemsize: int):
    """The masked GEMM needs only the kept columns: A and the kept columns
    of B read once, the mask read and C written once, against 2*M*K*kept
    + M*N operations (fp32 peak for fp32 operands, bf16 for bf16)."""
    nbytes = itemsize * (M * K + K * kept + M * N) + 4 * N
    flops = 2 * M * K * kept + M * N
    return set_bound(row, nbytes, flops, PEAK_FP32_FLOP_S if itemsize == 4
                     else PEAK_BF16_FLOP_S)


def check_row(kernel: str, row, ok: bool):
    print(f"kernel {kernel} " + json.dumps(row), flush=True)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version "
                             f"at {row['case']}: {row}")
    return row


def check_masked_matmul(cases, dtype: str = "float32"):
    """Phase 3: kernel against plain version at each (name, M, K, N, mask
    kind) with operands of ``dtype``; returns the per-case rows."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    with exact_fp32():
        for name, M, K, N, kind in cases:
            a = torch.randn(M, K, device="cuda", generator=gen).to(dt)
            b = (torch.randn(K, N, device="cuda", generator=gen)
                 / K ** 0.5).to(dt)
            if kind == "ones":
                m = torch.ones(N, device="cuda")
            elif kind == "zeros":
                m = torch.zeros(N, device="cuda")
            elif kind == "half":
                m = torch.zeros(N, device="cuda")
                m[torch.randperm(N, device="cuda", generator=gen)[:N // 2]] = 1
            else:
                m = (torch.rand(N, device="cuda", generator=gen)
                     < 0.5).float()
            got = masked_matmul(a, b, m)
            torch.cuda.synchronize()
            want = masked_matmul_ref(a, b, m)
            torch.cuda.synchronize()
            # tolerance: two fp32 sums of the same K products in different
            # orders differ by at most K·eps·(|A|@|B|) per element (each
            # errs by at most K·u·sum|a_k b_k|, u = eps/2); a bf16 output
            # adds one bf16 spacing of the value
            tol = K * eps * (a.float().abs() @ b.float().abs())
            if dtype == "bfloat16":
                tol = tol + BF16_SPACING * (want.float().abs() + tol)
            err = (got.float() - want.float()).abs()
            pruned_exact = bool((got[:, m == 0] == 0).all())
            ok = bool((err <= tol).all()) and pruned_exact
            row = {"case": name, "dtype": dtype, "M": M, "K": K, "N": N,
                   "mask": kind, "kept": int(m.sum()),
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "pruned_exact_zero": pruned_exact, "ok": ok,
                   "ms": time_ms(lambda: masked_matmul(a, b, m)),
                   "plain_ms": time_ms(lambda: masked_matmul_ref(a, b, m)),
                   "library_ms": time_ms(lambda: torch.matmul(a, b) * m)}
            masked_matmul_bound(row, M, K, N, row["kept"], a.element_size())
            rows.append(check_row("masked_matmul", row, ok))
            del a, b, got, want, tol, err
    return rows


def check_rmsnorm(cases):
    """Phase 3: the rmsnorm kernel against its plain version at each
    (name, rows, d, dtype, scale_offset)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for name, R, d, dtype, offset in cases:
        dt = getattr(torch, dtype)
        x = (3 * torch.randn(R, d, device="cuda", generator=gen)).to(dt)
        scale = (1 + 0.1 * torch.randn(d, device="cuda",
                                       generator=gen)).to(dt)
        got = rmsnorm(x, scale, 1e-6, offset)
        torch.cuda.synchronize()
        want = rmsnorm_ref(x, scale, 1e-6, offset).float()
        # tolerance: the two float32 sums of d squares in other orders
        # differ by at most d·eps relative, rsqrt against 1/sqrt and the two
        # products by a few eps more: (d/2 + 4)·eps·|y| after the root; a
        # bf16 output adds one bf16 spacing of the value
        tol = (d / 2 + 4) * eps32 * want.abs()
        if dtype == "bfloat16":
            tol = tol + BF16_SPACING * (want.abs() + tol)
        err = (got.float() - want).abs()
        ok = bool((err <= tol).all()) and got.dtype == dt
        w = scale + offset      # the library call takes the offset folded in
        row = {"case": name, "dtype": dtype, "rows": R, "d": d,
               "scale_offset": offset, "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
               "ok": ok,
               "ms": time_ms(lambda: rmsnorm(x, scale, 1e-6, offset)),
               "plain_ms": time_ms(lambda: rmsnorm_ref(x, scale, 1e-6,
                                                       offset)),
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))}
        # x read and y written once, the scale read once; about 4
        # operations an element (square-add, then two multiplies)
        set_bound(row, x.element_size() * (2 * R * d + d), 4 * R * d,
                  PEAK_FP32_FLOP_S)
        rows.append(check_row("rmsnorm", row, ok))
    return rows


def attention_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """How many (query, key) pairs the mask lets through."""
    import numpy as np
    d = np.arange(Sq)[:, None] - np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return int(ok.sum())


def check_flash(cases):
    """Phase 3: the flash kernel against its plain version at each (name,
    B, S, H, Hkv, D, causal, window, dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    with exact_fp32():
        for name, B, S, H, Hkv, D, causal, window, dtype in cases:
            dt = getattr(torch, dtype)
            q = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dt)
            k = torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(dt)
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, causal=causal,
                                 window=window).float()
            # tolerance: two float32 evaluations of the same softmax-
            # weighted sum (online over tiles against materialised) differ
            # by roundoff in the scores, exponentials and sums, a few eps
            # of max|v| an output; 64 eps of it leaves a wide margin. A bf16
            # output adds one bf16 spacing of the value
            tol = 64 * eps32 * float(v.float().abs().max())
            tol = torch.full_like(want, tol)
            if dtype == "bfloat16":
                tol = tol + BF16_SPACING * (want.abs() + tol)
            err = (got.float() - want).abs()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
            # the library call: one scaled_dot_product_attention on the
            # (B, H, S, D) views, GQA by its own head grouping, the window
            # as a boolean mask
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None:
                dd = (torch.arange(S, device="cuda")[:, None]
                      - torch.arange(S, device="cuda")[None, :])
                mask = dd < window
                if causal:
                    mask &= dd >= 0

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)
            row = {"case": name, "dtype": dtype, "B": B, "S": S, "H": H,
                   "Hkv": Hkv, "D": D, "causal": causal, "window": window,
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "ok": ok,
                   "ms": time_ms(lambda: flash_attention(
                       q, k, v, causal=causal, window=window)),
                   "plain_ms": time_ms(lambda: attention_ref(
                       q, k, v, causal=causal, window=window)),
                   "library_ms": time_ms(library)}
            # q, k, v read and the output written once; Q K^T and P V at 2
            # operations a multiply-add over the pairs the mask lets through
            pairs = attention_pairs(S, S, causal, window)
            set_bound(row, q.element_size() * (2 * q.numel() + 2 * k.numel()),
                      4 * B * H * D * pairs,
                      PEAK_FP32_FLOP_S if dtype == "float32"
                      else PEAK_BF16_FLOP_S)
            rows.append(check_row("flash_attention", row, ok))
            del q, k, v, got, want, tol, err
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


def device_profile(fn):
    """Device time by kernel for one call of ``fn`` (which ends in a
    synchronize), against that call's unprofiled host wall-clock, after a
    warm-up call; the first profiler pass, which pays the tracer's
    start-up, is discarded."""
    import torch
    fn()
    t0 = time.perf_counter()
    fn()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_ms": e.device_time_total / 1e3} for e in top]}


def profile_request(plan, image):
    """Phase 5: where one full-width AlexNet request's device time goes."""
    from repro_torch import serving
    sess = serving.connect(plan, backend="local")
    print("profile " + json.dumps({"split": plan.split,
                                   **device_profile(lambda: sess.infer(image))}),
          flush=True)


# ---------------------------------------------------------------------------
# phases 6-7: the pruned Qwen2-7B served by prefill and greedy decode
# ---------------------------------------------------------------------------
def qwen_setup(seed: int):
    """Full-width Qwen2-7B on the card: random bf16 weights from a seeded
    CUDA generator (``init_params`` draws one tensor at a time), random
    QKV biases and norm scales near 1 (the reference initialises them to 0
    and 1, which would leave the bias and scale paths untested), and masks
    from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit: half
    the KV groups, half the FFN channels of every layer."""
    import torch
    from repro_torch.configs.qwen2_7b import CONFIG
    from repro_torch.core.pruning.masks import (transformer_masks_from_ratios,
                                                transformer_prunable_units)
    from repro_torch.models import transformer as tr
    params = tr.init_params(CONFIG, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def fill(t, mean, std):
        t.copy_(mean + std * torch.randn(t.shape, device="cuda",
                                         generator=gen))
    for rp in params["runs"]:
        for name in ("bq", "bk", "bv"):
            fill(rp["attn"][name], 0.0, 0.1)
        fill(rp["ln1"], 1.0, 0.1)
        fill(rp["ln2"], 1.0, 0.1)
    fill(params["final_norm"], 1.0, 0.1)
    n = len(transformer_prunable_units(CONFIG))
    masks = transformer_masks_from_ratios(params, CONFIG, [0.5] * n)
    return CONFIG, params, masks


def serve_tokens(cfg, params, masks, tokens, plain: bool = False,
                 forced=None):
    """One request: prefill, then DECODE_STEPS greedy decode steps (or,
    with ``forced``, the given tokens: teacher forcing). The kernel path
    goes through the serving steps a launcher calls; ``plain`` calls the
    stack's plain versions on the card (``backend="ref"``), the yardstick.
    Returns every logit row (float32), the fed tokens and the host
    wall-clock of each step, each ending in a synchronize."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tr
    B, S = tokens.shape
    max_len = S + DECODE_STEPS
    if plain:
        def prefill(p, batch):
            tok = torch.as_tensor(batch["tokens"], device="cuda")
            return tr.prefill(p, cfg, {"tokens": tok}, max_len=max_len,
                              masks=masks, backend="ref")

        def decode(p, cache, tok):
            return tr.decode_step(p, cfg, cache, tok, masks=masks,
                                  backend="ref")
    else:
        prefill = make_prefill_step(cfg, max_len=max_len, masks=masks)
        decode = make_decode_step(cfg, masks=masks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits, fed, decode_ms = [lg.float()], [], []
    for t in range(DECODE_STEPS):
        nxt = (lg.argmax(-1, keepdim=True) if forced is None
               else forced[:, t:t + 1])
        fed.append(nxt)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, nxt)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg.float())
    return {"logits": logits, "tokens": torch.cat(fed, 1),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def transformer_wrappers():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    return {"rmsnorm": rmsnorm, "masked_matmul": masked_matmul,
            "flash_attention": flash_attention}


def transformer_slice(cfg, params, masks):
    """Phase 6: both requests through the kernel path with the launch
    counters zeroed just before and read just after each; the same
    requests through the plain versions in bf16 and in fp32, teacher-forced
    with the kernel path's tokens; every logit row held to the tolerance.
    Returns the per-request rows and the launch totals."""
    import numpy as np
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    wrappers = transformer_wrappers()
    L = cfg.num_layers
    # per forward step: two pre-norms a layer and the final norm; the up
    # and gate products of each layer's masked FFN; per prefill: one
    # attention a layer
    per_request = {"rmsnorm": (2 * L + 1) * (1 + DECODE_STEPS),
                   "masked_matmul": 2 * L * (1 + DECODE_STEPS),
                   "flash_attention": L}
    rng = np.random.default_rng(SEED)
    requests = [(label, rng.integers(0, cfg.vocab_size, (B, S)))
                for label, B, S in TRANSFORMER_REQUESTS]
    kern, totals = {}, dict.fromkeys(wrappers, 0)
    for label, tok in requests:
        for w in wrappers.values():
            w.launches = 0
        kern[label] = serve_tokens(cfg, params, masks, tok)
        counts = {name: w.launches for name, w in wrappers.items()}
        if counts != per_request:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{per_request}")
        kern[label]["launches"] = counts
        for name in totals:
            totals[name] += counts[name]
    plain = {label: serve_tokens(cfg, params, masks, tok, plain=True,
                                 forced=kern[label]["tokens"])
             for label, tok in requests}
    params32 = tr.cast_params(params, torch.float32)
    cfg32 = cfg.replace(dtype="float32")
    with exact_fp32():
        fp32 = {label: serve_tokens(cfg32, params32, masks, tok, plain=True,
                                    forced=kern[label]["tokens"])
                for label, tok in requests}
    del params32
    torch.cuda.empty_cache()

    rows = []
    for label, tok in requests:
        B, S = tok.shape
        worst, gaps_k, gaps_p, gaps_kp = 0.0, [], [], []
        for g, p, f in zip(kern[label]["logits"], plain[label]["logits"],
                           fp32[label]["logits"]):
            if g.shape != (B, cfg.vocab_size) or not bool(
                    torch.isfinite(g).all()):
                raise AssertionError(f"{label}: bad logits {tuple(g.shape)}")
            gap_k = float((g - f).abs().max())
            gap_p = float((p - f).abs().max())
            # tolerance: the kernel path may be no farther from the fp32
            # run than twice the bf16 plain run is, plus one bf16 spacing
            # of the largest logit
            tol = 2 * gap_p + BF16_SPACING * float(f.abs().max())
            worst = max(worst, gap_k / tol)
            gaps_k.append(gap_k)
            gaps_p.append(gap_p)
            gaps_kp.append(float((g - p).abs().max()))
        med = statistics.median(kern[label]["decode_ms"])
        row = {"request": label, "batch": B, "prompt": S,
               "decode_steps": DECODE_STEPS,
               "prefill_ms": kern[label]["prefill_ms"],
               "prefill_tokens_per_s": B * S / kern[label]["prefill_ms"] * 1e3,
               "decode_ms": kern[label]["decode_ms"],
               "decode_ms_median": med,
               "decode_tokens_per_s": B / med * 1e3,
               "plain_prefill_ms": plain[label]["prefill_ms"],
               "plain_decode_ms_median": statistics.median(
                   plain[label]["decode_ms"]),
               "launches": kern[label]["launches"],
               "max_gap_kernel_vs_fp32": max(gaps_k),
               "max_gap_bf16_plain_vs_fp32": max(gaps_p),
               "max_gap_kernel_vs_bf16_plain": max(gaps_kp),
               "max_gap_over_tol": worst,
               "tokens": kern[label]["tokens"].tolist()}
        print("slice " + json.dumps(row), flush=True)
        if worst > 1.0:
            raise AssertionError(f"{label}: kernel-path logits off by "
                                 f"{worst} of the tolerance")
        rows.append(row)
    return rows, totals


def profile_transformer(cfg, params, masks):
    """Phase 7: device time of one R1 prefill and one decode step of the
    kernel path, against their unprofiled wall-clock."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    _, B, S = TRANSFORMER_REQUESTS[0]
    tok = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, S))
    prefill = make_prefill_step(cfg, max_len=S + DECODE_STEPS, masks=masks)
    decode = make_decode_step(cfg, masks=masks)
    state = {}

    def prefill_once():
        state["lg"], state["cache"] = prefill(params, {"tokens": tok})
        torch.cuda.synchronize()

    def decode_once():
        nxt = state["lg"].argmax(-1, keepdim=True)
        state["lg"], state["cache"] = decode(params, state["cache"], nxt)
        torch.cuda.synchronize()
    for step, fn in (("prefill", prefill_once), ("decode", decode_once)):
        print("profile " + json.dumps({"model": cfg.name, "request": "R1",
                                       "step": step, **device_profile(fn)}),
              flush=True)


def kernel_entry(name, rows, main_rows, scale: int, launches: int,
                 **extra):
    """One kernel of the JSON line: times and bound summed over
    ``main_rows`` and multiplied by ``scale`` (how often one main-path
    request or prefill launches that shape), the worst error over all its
    checked ``rows``."""
    total = {k: scale * sum(r[k] for r in main_rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "bytes_ms", "ops_ms")}
    base = name.removesuffix("_bf16")
    return {"name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], **extra, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                         else "operations"),
            "library_ms": total["library_ms"]}


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
    kernels_only = "--kernels-only" in sys.argv[1:]

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
    # Qwen2-7B: d_model 3584, d_ff 18944, 28 heads / 4 KV heads of 128
    d, dff = 3584, 18944
    rows16 = check_masked_matmul(
        [("ffn prefill R1", 2048, d, dff, "half"),
         ("ffn prefill R2", 2000, d, dff, "half"),
         ("ffn decode R1", 1, d, dff, "half"),
         ("ffn decode R2", 2, d, dff, "half"),
         ("ragged", 77, 29, 45, "partial")], dtype="bfloat16")
    norm_rows = check_rmsnorm(
        [(f"{r} rows {dt} +{off:g}", r, d, dt, off)
         for r in (2048, 2000, 1000) for dt in ("bfloat16", "float32")
         for off in (0.0, 1.0)]
        + [("decode rows 1 bfloat16 +0", 1, d, "bfloat16", 0.0),
           ("decode rows 2 bfloat16 +0", 2, d, "bfloat16", 0.0),
           ("ragged", 3, 77, "bfloat16", 1.0)])
    flash_rows = check_flash(
        [("prefill R1", 1, 2048, 28, 4, 128, True, None, "bfloat16"),
         ("prefill R2", 2, 1000, 28, 4, 128, True, None, "bfloat16"),
         ("window 512", 1, 2048, 28, 4, 128, True, 512, "bfloat16"),
         ("noncausal", 1, 1000, 28, 4, 128, False, None, "bfloat16"),
         ("window noncausal", 1, 300, 28, 4, 128, False, 40, "bfloat16"),
         ("fp32", 1, 512, 28, 4, 128, True, None, "float32"),
         ("head dim 64", 2, 300, 8, 2, 64, True, None, "bfloat16"),
         ("ragged 77", 1, 77, 28, 4, 128, True, None, "bfloat16")])
    if kernels_only:
        print(smi, flush=True)
        return 0

    # 4. the AlexNet slice at full width
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

    # 5. where one full-width AlexNet request's device time goes
    profile_request(plans["greedy"], images[0])
    profile_request(plans["c13"], images[0])
    del plans
    torch.cuda.empty_cache()

    # 6. the pruned Qwen2-7B at full width, served by prefill and decode
    qcfg, qparams, qmasks = qwen_setup(SEED)
    from repro_torch.models.transformer import param_count
    print("slice " + json.dumps({
        "model": qcfg.name, "num_layers": qcfg.num_layers,
        "d_model": qcfg.d_model, "num_heads": qcfg.num_heads,
        "num_kv_heads": qcfg.num_kv_heads, "head_dim": qcfg.head_dim,
        "d_ff": qcfg.d_ff, "vocab_size": qcfg.vocab_size,
        "dtype": qcfg.dtype, "params": param_count(qparams),
        "kept_heads_per_layer": float(qmasks[0]["head_mask"].sum(1)[0]),
        "kept_ffn_per_layer": float(qmasks[0]["ffn_mask"].sum(1)[0])}),
        flush=True)
    _, totals = transformer_slice(qcfg, qparams, qmasks)

    # 7. where one R1 prefill's and one decode step's device time goes
    profile_transformer(qcfg, qparams, qmasks)
    del qparams
    torch.cuda.empty_cache()

    # times of the kernel line: masked_matmul (fp32) summed over the GEMMs
    # of one c=N request of the compacted AlexNet plan (each conv and dense
    # layer once); the transformer's kernels over one R1 prefill (56 FFN
    # products, 57 norms, 28 attentions at the prefill's shapes)
    L = qcfg.num_layers

    def case(rs, name):
        return [r for r in rs if r["case"] == name]
    kernels = [
        kernel_entry("masked_matmul", rows,
                     [r for r in rows if r["case"].endswith(" compact")], 1,
                     launches, dtype="float32"),
        kernel_entry("masked_matmul_bf16", rows16,
                     case(rows16, "ffn prefill R1"), 2 * L,
                     totals["masked_matmul"], dtype="bfloat16"),
        kernel_entry("rmsnorm", norm_rows,
                     case(norm_rows, "2048 rows bfloat16 +0"), 2 * L + 1,
                     totals["rmsnorm"]),
        kernel_entry("flash_attention", flash_rows,
                     case(flash_rows, "prefill R1"), L,
                     totals["flash_attention"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
