#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # from the repository root; one card
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels

Phases, each printing its own lines:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — every CUDA kernel of the paths, compiled from ``src/repro_torch/
   csrc`` in parallel (one nvcc per source), with ptxas's resource report;
   every ``flash_attention`` instance must report 0 bytes of spills;
3. kernels — each kernel's wrapper on card tensors at every shape the main
   paths give it, plus edge cases, held against its plain PyTorch version
   with the tolerance stated beside it, and timed with CUDA events beside
   the plain version (rounds taken in turn), one PyTorch call computing
   the same function (``library_ms``) and the card's bound; ``device_ms``
   is the same call replayed from a CUDA graph, without the host's
   enqueue, each call on its own copy of the operands so that they come
   from memory, not from L2, and it must not beat the bound: the fp32
   ``masked_matmul`` at every GEMM of full-width AlexNet (uncompacted and
   with half of every prunable layer's channels compacted away), each row
   naming the route and plan it takes (split-K GEMV, split-K cluster tiles)
   and holding a second call to the same bits; ``masked_matmul_q8`` (int8
   codes dequantized in the kernel's load) at the same full and compacted
   shapes (every shape an int8 plan of phase 4 launches), its
   split-K results bit-identical to the float32 route's on the dequantized
   weights; one ``crossover`` line per M of 1-32 timing the float32 GEMV
   against the split-K tiles at dense14's shape; the bf16 ``masked_matmul`` at
   Qwen2-7B's FFN up/gate shapes (M = 2048 and 2000 in prefill, 1 and 2 in
   decode, and 3, 8, 9, 16, 64; K = 3584; N = 18944; half the columns
   masked) and at ragged and all-zero-mask shapes, each row naming the
   entry its route picks (the decode GEMV, the wgmma/TMA tiles, the
   CUDA-core tiles), then one ``crossover`` line per M of 1, 2, 3, 4, 8, 16, 64
   timing the GEMV and the tiles on the same operands, and a ``host`` line
   with one call's host time (the bf16, float32 and codes GEMV wrappers,
   ``matmul * mask``); ``rmsnorm`` at
   2048 and 2000 rows of 3584 (R1's and R2's prefill) and 1000, bf16 and
   fp32, offsets 0 and 1, and at 1 and 2 rows (decode), with its and
   ``F.rms_norm``'s device time; ``flash_attention`` at (B=1,
   S=2048) and (B=2, S=1000) with 28/4 heads of 128, causal, plus windowed,
   non-causal, fp32, head-dim 64 and ragged (S=77) cases, Zamba2's
   shared attention (32/32 heads of 64, S=2048), gemma-7b's R1 (16/16 heads
   of 256, S=2048) and nemotron-4-340b's heads (96/8 of 192, S=2048), each
   of the two head dims also ragged (S=77) and in fp32; ``ssd_scan`` at
   Mamba2's R1 (B=1, S=2048, 80 heads of 64, d_state 128) and R2 (B=2, S=1000,
   ragged), Zamba2's R1 (64 heads, d_state 64), with half the heads masked,
   x, B and C as slices of one conv output as the block hands them in, plus
   2 groups, S=77, S=1, every head pruned and fp32 cases, the device time
   of each of the bf16 entry's three launches at the two R1 cases;
4. slice (AlexNet) — the paper's int8-quantized, compacted AlexNet
   (``alexnet_config(38)``, 224x224x3, random weights from a seed) served
   through ``repro_torch.serving.connect(plan, backend="local")`` on the
   card at the greedy split, at c=13 (every conv on the edge) and at c=N
   (every layer through the kernel), plus one uncompacted masked plan and
   one c=N plan with float32 weights; the kernel's launch count must equal
   (edge conv+dense layers) x requests, each on the route its shape picks
   (from codes where the plan quantizes), and
   the logits and wire bytes must match the same plan served on the CPU;
5. profile (AlexNet) — where one full-width request's device time goes;
6. slice (Qwen2-7B) — the pruned dense transformer at full width and depth
   (``configs/qwen2_7b.CONFIG``: 28 layers, d_model 3584, 28/4 heads, d_ff
   18944, vocab 152064, bf16; random weights from a seeded CUDA generator;
   masks from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit)
   serving two requests through ``launch.steps.make_prefill_step`` and 16
   greedy ``make_decode_step`` steps each: R1 (B=1, S=2048) and R2 (B=2,
   S=1000). The launch counts must be 57 rmsnorm and 56 masked_matmul per
   forward step and 28 flash_attention per prefill, the prefill's products
   on the wgmma tiles and the decode steps' on the GEMV. The same requests run
   through the plain versions on the card in bf16 and in fp32 (teacher-
   forced with the kernel path's tokens); every logit row of the kernel
   path must lie within twice the bf16 plain run's distance from the fp32
   run, plus one bf16 spacing of the largest logit;
7. profile (Qwen2-7B) — where one R1 prefill's and one decode step's device
   time goes;
8. slice (Mamba2-2.7B) — the pruned SSM at full width and depth
   (``configs/mamba2_2p7b.CONFIG``: 64 layers, d_model 2560, 80 SSD heads of
   64, d_state 128, vocab 50304, bf16; masks at ratio 0.5 keep 40 heads a
   layer) serving R1 and R2 as in phase 6: 64 ssd_scan launches per prefill
   and none per decode step, 65 rmsnorm per forward step; the same logit
   yardstick;
9. slice (Zamba2-1.2B) — the pruned hybrid at full width and depth
   (``configs/zamba2_1p2b.CONFIG``: 38 Mamba2 layers of 64 heads, d_state
   64, one shared attention + GELU-MLP block after every 6th, so 6 groups
   and a tail of 2) serving R1: 38 ssd_scan and 6 flash_attention launches
   per prefill, 51 rmsnorm per forward step; the same logit yardstick;
10. profile (Mamba2-2.7B) — where one R1 prefill's and one decode step's
   device time goes;
11. socket (AlexNet) — phase 4's int8 compacted plans served through
   ``serving.CloudServer(plan)`` on 127.0.0.1 and ``serving.connect(plan,
   backend="socket")``, both peers on the card in this process: c=19 (the
   logits cross the wire) and c=13 (the dense layers in the cloud), then
   c=13 with a ``faults`` section and a server that drops one response and
   corrupts another (both recovered by replay), each with ``REQUESTS``
   images sent one after another, every logit row and ``tx_bytes`` equal,
   bit for bit, to the local backend's (at c=19 to its logits through the
   codec), ``masked_matmul`` launches = edge GEMMs x requests on their
   routes; and c=13 with a ``batching`` section (``max_batch`` 4), one
   client alone and then 4 sessions at once, 8 images each, every row equal
   to the sequential logits, the lanes showing batches of more than one
   row. One ``socket`` line per plan: per-request wall ms (median, p90)
   beside the local backend's, and the batched run's req/s beside one
   client's.

It then prints the kernels' JSON line (the ``masked_matmul`` launches of
phases 4 and 11, counted where one thread launches), the nvidia-smi line,
and as its last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero without that line; so does a machine without a CUDA device.
"""
from __future__ import annotations

import collections
import json
import os
import re
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
#: the card's L2 cache (50 MB on an H100 SXM), and the most operand copies
#: ``graph_ms`` rotates through to read past it
L2_BYTES = 50 * 2 ** 20
GRAPH_COPIES = 256
#: the TPU kernel each CUDA kernel replaces
REPLACES = {"masked_matmul": "src/repro/kernels/masked_matmul/kernel.py:26",
            "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:20",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:38",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:36"}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
#: bf16 keeps 8 significant bits: two roundings of nearby fp32 values to
#: bf16 differ by at most their gap plus 2**-7 of the value
BF16_SPACING = 2.0 ** -7
#: the transformer requests: (label, batch, prompt length); 16 decode steps
TRANSFORMER_REQUESTS = (("R1", 1, 2048), ("R2", 2, 1000))
#: float32 eps
EPS32 = 2.0 ** -23
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
    return time_interleaved_ms({"": fn}, reps, rounds)[""]


def time_interleaved_ms(fns, reps: int = 20, rounds: int = 5):
    """``time_ms`` of each function of the dict ``fns``, their rounds taken
    in turn (one round of each, then the next), so that a stretch of host
    noise falls on all of them alike; a dict of the medians."""
    import torch

    def one_round(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n
    n = {k: max(3, min(reps, int(50.0 / max(one_round(fn, 1), 1e-3))))
         for k, fn in fns.items()}
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            samples[k].append(one_round(fn, n[k]))
    return {k: statistics.median(v) for k, v in samples.items()}


def copy_like(t):
    """``t`` in new memory: its whole storage copied, then viewed with its
    own sizes, strides and offset (a slice of a larger tensor stays one)."""
    import torch
    storage = t.untyped_storage()
    flat = torch.empty(0, dtype=t.dtype, device=t.device).set_(
        storage, 0, (storage.nbytes() // t.element_size(),)).clone()
    return flat.as_strided(t.shape, t.stride(), t.storage_offset())


def graph_ms(fn, *operands, reps: int = 20) -> float:
    """Device time of one ``fn(*operands)`` with its operands read from the
    card's memory: calls captured in a CUDA graph after a warm-up call, each
    on its own copy of the operands, as many copies as together exceed
    three times the L2 (at most ``GRAPH_COPIES``: operands under 0.6 MB may
    stay in L2, where reading them from memory would cost under 0.2 µs),
    so that no call finds its inputs left in L2 by the calls before it; the
    graph replayed as ``time_ms`` times it. Back-to-back calls of a small
    kernel wait on the host's enqueue (a wrapper call costs tens of µs);
    the replay does not."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    copies = max(2, min(GRAPH_COPIES, -(-3 * L2_BYTES // max(nbytes, 1))))
    sets = [operands] + [tuple(copy_like(t) for t in operands)
                         for _ in range(copies - 1)]
    calls = max(reps, copies)
    fn(*operands)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            fn(*sets[i % copies])
    torch.cuda.synchronize()
    ms = time_ms(graph.replay, reps=5) / calls
    del graph, sets
    return ms


def hold_to_bound(row):
    """No time measured on the card can beat the card's bound: a device
    time under ``bound_ms`` means the replay did not read its operands from
    memory. Adds ``device_over_bound`` (and the library's) to ``row``;
    returns whether both are at least 1."""
    row["device_over_bound"] = row["device_ms"] / row["bound_ms"]
    ok = row["device_over_bound"] >= 1.0
    if row.get("library_device_ms") is not None:
        row["library_device_over_bound"] = (row["library_device_ms"]
                                            / row["bound_ms"])
        ok = ok and row["library_device_over_bound"] >= 1.0
    return ok


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
                        itemsize: int, codes: bool = False):
    """The masked GEMM needs only the kept columns: A and the kept columns
    of B read once, the mask read and C written once, against 2*M*K*kept
    + M*N operations (fp32 peak for fp32 operands, bf16 for bf16). With
    ``codes`` B is read at 1 byte an element, plus its float32 scale and
    zero, and each kept code costs a dequant (2 operations) once."""
    b_bytes = K * kept if codes else itemsize * K * kept
    nbytes = itemsize * (M * K + M * N) + b_bytes + 4 * N + (8 * N if codes
                                                             else 0)
    flops = 2 * M * K * kept + M * N + (2 * K * kept if codes else 0)
    return set_bound(row, nbytes, flops, PEAK_FP32_FLOP_S if itemsize == 4
                     else PEAK_BF16_FLOP_S)


def check_no_spills(name: str, log: str) -> None:
    """Phase 2: every kernel instance ptxas compiled for ``name`` (each
    ``Compiling entry`` of its log) reports 0 bytes of spill stores and
    loads; prints one ``build`` line with the count."""
    entries = log.count("Compiling entry")
    spills = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    bad = [sp for sp in spills if sp != (0, 0)]
    print(f"build {name}: {entries} instances, {len(spills)} spill reports, "
          f"{len(bad)} with spills", flush=True)
    if not entries or len(spills) < entries or bad:
        raise AssertionError(f"{name}: ptxas reports spills or no report "
                             f"({entries} instances, spills {spills})")


def check_row(kernel: str, row, ok: bool):
    print(f"kernel {kernel} " + json.dumps(row), flush=True)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version "
                             f"at {row['case']}: {row}")
    return row


def matmul_times_mask(a, b, m):
    """The library call computing the masked GEMM."""
    import torch
    return torch.matmul(a, b) * m


def check_masked_matmul(cases, dtype: str = "float32"):
    """Phase 3: kernel against plain version at each (name, M, K, N, mask
    kind) with operands of ``dtype``; returns the per-case rows."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul.ops import _plan, masked_matmul
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
            entry, plan = _plan(dt, M, K, N)
            # the cluster routes sum their partial tiles in a fixed order:
            # a second call gives the same bits
            same = (bool(torch.equal(got, masked_matmul(a, b, m)))
                    if plan else None)
            ok = ok and same is not False
            row = {"case": name, "dtype": dtype, "M": M, "K": K, "N": N,
                   "mask": kind, "kept": int(m.sum()), "entry": entry,
                   "plan": list(plan), "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "pruned_exact_zero": pruned_exact,
                   "bit_identical_rerun": same,
                   **time_interleaved_ms(
                       {"ms": lambda: masked_matmul(a, b, m),
                        "plain_ms": lambda: masked_matmul_ref(a, b, m),
                        "library_ms": lambda: torch.matmul(a, b) * m},
                       rounds=9),
                   "device_ms": graph_ms(masked_matmul, a, b, m),
                   "library_device_ms": graph_ms(matmul_times_mask, a, b, m)}
            masked_matmul_bound(row, M, K, N, row["kept"], a.element_size())
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("masked_matmul", row, ok))
            del a, b, got, want, tol, err
    return rows


def q8_operands(M: int, K: int, N: int, gen):
    """A float32 (M, K) and uint8 codes (K, N) with per-column scale and
    zero as ``quantize_weights`` makes them (zero the column's minimum,
    scale its range over 255 levels), for weights of spread K**-0.5."""
    import torch
    a = torch.randn(M, K, device="cuda", generator=gen)
    codes = torch.randint(0, 256, (K, N), device="cuda", generator=gen,
                          dtype=torch.uint8)
    spread = (1 + torch.rand(N, device="cuda", generator=gen)) / K ** 0.5
    scale = 2 * spread / 255
    zero = -spread * (1 + 0.1 * torch.rand(N, device="cuda", generator=gen))
    return a, codes, scale, zero


def check_masked_matmul_q8(cases):
    """Phase 3: ``masked_matmul_q8`` (codes dequantized in the kernel's
    load) against the plain version after the dequant, ``codes * scale +
    zero`` as ``quant.dequantize_weights`` rounds it, at each (name, M, K,
    N, mask kind); the library call is ``torch.matmul`` on the dequantized
    B times the mask. The split-K route must also give, bit for bit, what
    the float32 split-K route gives on the dequantized B (the same tiles and
    split, so the same sums in the same order: the dequant is exact)."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    with exact_fp32():
        for name, M, K, N, kind in cases:
            a, codes, scale, zero = q8_operands(M, K, N, gen)
            m = (torch.ones(N, device="cuda") if kind == "ones" else
                 (torch.rand(N, device="cuda", generator=gen) < 0.5).float())

            def plain():
                return masked_matmul_ref(a, codes.float() * scale + zero, m)

            def library(a, codes, scale, zero, m):
                return torch.matmul(a, codes.float() * scale + zero) * m
            got = ops.masked_matmul_q8(a, codes, scale, zero, m)
            torch.cuda.synchronize()
            b = codes.float() * scale + zero
            want = masked_matmul_ref(a, b, m)
            tol = K * eps * (a.abs() @ b.abs())
            err = (got - want).abs()
            pruned_exact = bool((got[:, m == 0] == 0).all())
            entry, plan = ops._plan(torch.uint8, M, K, N)
            same = bool(torch.equal(
                got, ops.masked_matmul_q8(a, codes, scale, zero, m)))
            as_f32 = None
            if entry == ops._ENTRIES["q8_splitk"]:
                as_f32 = bool(torch.equal(got, ops._launch(
                    a, b, m, ops._ENTRIES["f32_splitk"], plan)))
            ok = (bool((err <= tol).all()) and pruned_exact and same
                  and as_f32 is not False)
            operands = (a, codes, scale, zero, m)
            row = {"case": name, "dtype": "uint8 codes", "M": M, "K": K,
                   "N": N, "mask": kind, "kept": int(m.sum()),
                   "entry": entry, "plan": list(plan),
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "pruned_exact_zero": pruned_exact,
                   "bit_identical_rerun": same,
                   "bit_identical_to_f32_splitk": as_f32,
                   **time_interleaved_ms(
                       {"ms": lambda: ops.masked_matmul_q8(*operands),
                        "plain_ms": plain,
                        "library_ms": lambda: library(*operands)},
                       rounds=9),
                   "device_ms": graph_ms(ops.masked_matmul_q8, *operands),
                   "library_device_ms": graph_ms(library, *operands)}
            masked_matmul_bound(row, M, K, N, row["kept"], 4, codes=True)
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("masked_matmul", row, ok))
            del a, codes, b, got, want, tol, err
    return rows


def f32_gemv_splitk_crossover(rows_m, K: int, N: int):
    """Phase 3: the float32 product at each M of ``rows_m`` through the
    split-K GEMV and the split-K tiles, each with the plan the host would
    give it, whatever ``_route`` picks: each held to ``check_masked_matmul``'s
    tolerance and timed from a CUDA graph (device time) and back to back;
    one ``crossover`` line per M. These launches are for comparison only."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    with exact_fp32():
        for M in rows_m:
            a = torch.randn(M, K, device="cuda", generator=gen)
            b = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
            m = torch.ones(N, device="cuda")
            want = masked_matmul_ref(a, b, m)
            tol = K * eps * (a.abs() @ b.abs())
            routes = {"gemv": (ops._ENTRIES["f32_gemv"],
                               ops._gemv_f32_plan(False, M, K, N, True)),
                      "splitk": (ops._ENTRIES["f32_splitk"],
                                 ops._splitk_plan(M, K, N)
                                 + (4 if N % 4 == 0 else 1,))}
            row = {"dtype": "float32", "M": M, "K": K, "N": N,
                   "entry": ops._route(torch.float32, M, K, N)}
            for label, (symbol, plan) in routes.items():
                got = ops._launch(a, b, m, symbol, plan)
                torch.cuda.synchronize()
                over = float(((got - want).abs() / tol.clamp_min(1e-30))
                             .max())
                if over > 1.0:
                    raise AssertionError(f"masked_matmul {label} route at "
                                         f"M={M} disagrees with its plain "
                                         f"version ({over} of the tolerance)")
                row[f"{label}_plan"] = list(plan)
                row[f"{label}_device_ms"] = graph_ms(
                    lambda a, b, m: ops._launch(a, b, m, symbol, plan),
                    a, b, m)
                row[f"{label}_ms"] = time_ms(
                    lambda: ops._launch(a, b, m, symbol, plan))
                row[f"{label}_err_over_tol"] = over
            row["library_device_ms"] = graph_ms(matmul_times_mask, a, b, m)
            print("crossover " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def gemv_tiles_crossover(rows_m, K: int, N: int):
    """Phase 3: the bf16 product at each M of ``rows_m`` through both
    Hopper routes, the GEMV and the wgmma tiles, whatever ``_route`` would
    pick: each held against the plain version with the tolerance of
    ``check_masked_matmul`` and timed; one ``crossover`` line per M. These
    launches are for comparison only."""
    import torch
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    routes = {"gemv": ops._ENTRIES["gemv"], "tiles": ops._ENTRIES["tiles"]}
    rows = []
    for M in rows_m:
        a = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        b = (torch.randn(K, N, device="cuda", generator=gen)
             / K ** 0.5).to(torch.bfloat16)
        m = torch.zeros(N, device="cuda")
        m[torch.randperm(N, device="cuda", generator=gen)[:N // 2]] = 1
        want = masked_matmul_ref(a, b, m).float()
        tol = K * eps * (a.float().abs() @ b.float().abs())
        tol = tol + BF16_SPACING * (want.abs() + tol)
        row = {"M": M, "K": K, "N": N, "entry": ops._route(
            torch.bfloat16, M, K, N)}
        for label, symbol in routes.items():
            got = ops._launch(a, b, m, symbol).float()
            torch.cuda.synchronize()
            over = float(((got - want).abs() / tol.clamp_min(1e-30)).max())
            if over > 1.0 or not bool((got[:, m == 0] == 0).all()):
                raise AssertionError(f"masked_matmul {label} route at M={M}"
                                     f" disagrees with its plain version "
                                     f"({over} of the tolerance)")
            row[f"{label}_ms"] = time_ms(
                lambda: ops._launch(a, b, m, symbol))
            row[f"{label}_err_over_tol"] = over
        row["library_ms"] = time_ms(lambda: torch.matmul(a, b) * m)
        print("crossover " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def launch_host_us(K: int, N: int, K32: int, N32: int, calls: int = 200):
    """Host time of one call (enqueue only: the card is faster than the
    host at these shapes, so no call waits; median of 5 batches of
    ``calls``) of the bf16 decode GEMV's wrapper at (1, K) @ (K, N), and of
    the float32 GEMV's and codes GEMV's wrappers and ``matmul * mask`` at
    (1, K32) @ (K32, N32) (dense14's compacted shape); and the time of the
    symbol lookup and ``argtypes`` assignment that ``build.launch`` does
    once per entry instead of on every call."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.masked_matmul import ops

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            samples.append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
        return statistics.median(samples)
    a = torch.randn(1, K, device="cuda").to(torch.bfloat16)
    b = torch.randn(K, N, device="cuda").to(torch.bfloat16)
    m = torch.ones(N, device="cuda")
    a32 = torch.randn(1, K32, device="cuda")
    b32 = torch.randn(K32, N32, device="cuda")
    codes = torch.randint(0, 256, (K32, N32), device="cuda",
                          dtype=torch.uint8)
    scale, zero = torch.rand(N32, device="cuda"), torch.rand(N32,
                                                             device="cuda")
    m32 = torch.ones(N32, device="cuda")
    row = {"wrapper_call_host_us": host_us(
               lambda: ops.masked_matmul(a, b, m)),
           "f32_gemv_call_host_us": host_us(
               lambda: ops.masked_matmul(a32, b32, m32)),
           "q8_gemv_call_host_us": host_us(
               lambda: ops.masked_matmul_q8(a32, codes, scale, zero, m32)),
           "matmul_times_mask_host_us": host_us(
               lambda: matmul_times_mask(a32, b32, m32))}
    lib = build.load("masked_matmul")
    t0 = time.perf_counter()
    for _ in range(20 * calls):
        fn = getattr(lib, ops._ENTRIES["gemv"])
        fn.argtypes = [*ops._ARGTYPES, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    row["per_call_lookup_removed_us"] = (1e6 * (time.perf_counter() - t0)
                                         / (20 * calls))
    print("host " + json.dumps(row), flush=True)
    return row


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
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
               "device_ms": graph_ms(
                   lambda x, scale: rmsnorm(x, scale, 1e-6, offset),
                   x, scale),
               "library_device_ms": graph_ms(
                   lambda x, w: F.rms_norm(x, (d,), w, 1e-6), x, w)}
        # x read and y written once, the scale read once; about 4
        # operations an element (square-add, then two multiplies)
        set_bound(row, x.element_size() * (2 * R * d + d), 4 * R * d,
                  PEAK_FP32_FLOP_S)
        row["ok"] = ok = ok and hold_to_bound(row)
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
            # of max|v| an output; 64 eps of it leaves a wide margin. The
            # bf16 kernel rounds P to bf16 before P V (at most 2**-8 of
            # each weight, so 2**-8 * max|v| an output, l summed from the
            # fp32 P), and its output adds one bf16 spacing of the value
            vmax = float(v.float().abs().max())
            tol = torch.full_like(want, 64 * eps32 * vmax)
            if dtype == "bfloat16":
                tol = tol + 2.0 ** -8 * vmax
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


def ssd_inputs(B: int, S: int, H: int, G: int, P: int, N: int, dtype: str,
               gen):
    """The scan's inputs as the Mamba2 block hands them in: x, B and C as
    slices of one (B, S, H*P + 2*G*N) conv output in ``dtype``; dt =
    softplus(u + dt_bias) in float32 with u normal and dt_bias the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1] per head; A = -linspace(1,
    16, H), the reference's init, so that the fast heads decay by up to
    e^-16 a step and exp above the decay matrix's diagonal overflows."""
    import math
    import torch
    import torch.nn.functional as F
    dt_ = getattr(torch, dtype)
    xBC = torch.randn(B, S, H * P + 2 * G * N, device="cuda",
                      generator=gen).to(dt_)
    xh = xBC[..., :H * P].reshape(B, S, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xBC[..., H * P + G * N:].reshape(B, S, G, N)
    u = torch.rand(H, device="cuda", generator=gen)
    d0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    bias = d0 + torch.log(-torch.expm1(-d0))
    dt = F.softplus(torch.randn(B, S, H, device="cuda", generator=gen)
                    + bias)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    return xh, dt, A, Bm, Cm


def ssd_tolerance(xh, dt, A, Bm, Cm, chunk: int):
    """Elementwise bounds (on y, on the final state) between two float32
    evaluations of the chunked SSD scan that sum in other orders or walk
    other chunk lengths up to ``chunk`` (the kernel 64, the plain version
    256). Every output is a sum of products of x, B, C, step sizes and
    decay factors in [0, 1]; the plain version on |x|, |B|, |C| gives the
    sum of their magnitudes, M. A float32 dot product of length n errs by at
    most n·eps/2·M: the lengths are N (C·B), the chunk (W·x and the chunk's
    state) and the number of chunks (the carried state); the decay
    exponents are differences of within-chunk cumulative sums, rounded by
    eps·|cs| at most, which is the relative error of their exp: so
    (N + chunk + n_chunks + 2·max|cs|)·eps·M."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    S, N = xh.shape[1], Bm.shape[3]
    Q = max(1, min(chunk, S))
    mag_y, mag_s = ssd_chunked(xh.float().abs(), dt, A, Bm.float().abs(),
                               Cm.float().abs(), Q)
    nc = -(-S // Q)
    da = F.pad(dt * A.abs(), (0, 0, 0, nc * Q - S))
    cs_max = float(da.reshape(da.shape[0], nc, Q, -1).sum(2).max())
    k = (N + Q + nc + 2 * cs_max) * EPS32
    return k * mag_y, k * mag_s


def ssd_bound(row, B, S, H, G, P, N, itemsize, kept_heads, chunk=256):
    """Bytes: x, B, C, dt, A and the head mask read once, y and the float32
    state written once. Operations, at the reference's chunk: per chunk of
    q steps, the causal half of C·B^T (q(q+1)/2·N multiply-adds) and of W·x
    (q(q+1)/2·P), C·state^T and the state update (q·P·N each) for a kept
    head; only the state update for a pruned one (its y is zeros, its state
    is still written). At the peak of the inputs' type."""
    nbytes = (itemsize * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + 2 * H + B * H * P * N))
    mac_kept = mac_pruned = 0
    for s0 in range(0, S, chunk):
        q = min(chunk, S - s0)
        mac_kept += q * (q + 1) // 2 * (N + P) + 2 * q * P * N
        mac_pruned += q * P * N
    flops = 2 * B * (kept_heads * mac_kept + (H - kept_heads) * mac_pruned)
    return set_bound(row, nbytes, flops, PEAK_FP32_FLOP_S if itemsize == 4
                     else PEAK_BF16_FLOP_S)


def check_ssd(cases, profile_cases=()):
    """Phase 3: the SSD scan kernel against its plain version at each (name,
    B, S, H, G, P, N, dtype, mask), mask one of "half" (a random half of the
    heads pruned, as the main path's ratio-0.5 masks), "none", "zeros"
    (every head pruned): y and the final state, pruned heads' y exact
    zeros. No PyTorch call computes the SSD scan, so ``library_ms`` is
    null. The cases named in ``profile_cases`` also give each launch's
    device time (``passes_ms``)."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    with exact_fp32():
        for name, B, S, H, G, P, N, dtype, kind in cases:
            xh, dt, A, Bm, Cm = ssd_inputs(B, S, H, G, P, N, dtype, gen)
            hm = {"half": (torch.randperm(H, device="cuda", generator=gen)
                           < H // 2).float(),
                  "none": torch.ones(H, device="cuda"),
                  "zeros": torch.zeros(H, device="cuda")}[kind]
            got_y, got_s = ssd_scan(xh, dt, A, Bm, Cm, hm, 256)
            torch.cuda.synchronize()
            want_y, want_s = ssd_chunked(xh, dt, A, Bm, Cm, min(256, S))
            want_y = want_y * hm[None, None, :, None]
            tol_y, tol_s = ssd_tolerance(xh, dt, A, Bm, Cm, 256)
            tol_y = tol_y * hm[None, None, :, None]
            if dtype == "bfloat16":
                tol_y = tol_y + BF16_SPACING * (want_y.abs() + tol_y)
            err_y = (got_y.float() - want_y).abs()
            err_s = (got_s - want_s).abs()
            pruned_exact = bool((got_y[:, :, hm == 0] == 0).all())
            ok = (bool((err_y <= tol_y).all()) and bool((err_s <= tol_s).all())
                  and pruned_exact and got_y.dtype == xh.dtype
                  and bool(torch.isfinite(got_y).all()))
            over = max(float((err_y / tol_y.clamp_min(1e-30)).max()),
                       float((err_s / tol_s.clamp_min(1e-30)).max()))
            row = {"case": name, "dtype": dtype, "B": B, "S": S, "H": H,
                   "G": G, "P": P, "N": N, "mask": kind,
                   "kept_heads": int(hm.sum()),
                   "max_abs_err": max(float(err_y.max()), float(err_s.max())),
                   "max_abs_err_state": float(err_s.max()),
                   "max_err_over_tol": over,
                   "pruned_exact_zero": pruned_exact, "ok": ok,
                   "ms": time_ms(lambda: ssd_scan(xh, dt, A, Bm, Cm, hm,
                                                  256)),
                   "device_ms": graph_ms(ssd_scan, xh, dt, A, Bm, Cm, hm),
                   "plain_ms": time_ms(lambda: ssd_scan_ref(
                       xh, dt, A, Bm, Cm, hm, 256)),
                   "library_ms": None}
            if name in profile_cases:
                # device ms of each launch of one call, by kernel
                prof = device_profile(lambda: (ssd_scan(xh, dt, A, Bm, Cm,
                                                        hm, 256),
                                               torch.cuda.synchronize()))
                row["passes_ms"] = {
                    re.search(r"ssd_\w+_kernel", e["name"]).group(0):
                    e["device_ms"] for e in prof["top"] if "ssd_" in e["name"]}
            ssd_bound(row, B, S, H, G, P, N, xh.element_size(),
                      row["kept_heads"])
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("ssd_scan", row, ok))
            del xh, dt, Bm, Cm, got_y, got_s, want_y, want_s, tol_y, tol_s
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
    from repro_torch.core.collab.runtime import deploy_submodels
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
    masked_matmul.route_launches = dict.fromkeys(
        masked_matmul.route_launches, 0)
    got = sess.infer_many(images)
    launches = masked_matmul.launches
    routes = {k: v for k, v in masked_matmul.route_launches.items() if v}
    want_routes = {k: v * len(images) for k, v in edge_routes(plan).items()}
    if routes != want_routes:
        raise AssertionError(f"{label}: masked_matmul routes {routes}, "
                             f"expected {want_routes}")
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
           "weight_bits": plan.quant.weight_bits,
           "requests": len(images), "launches": launches, "routes": routes,
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


def edge_routes(plan):
    """``masked_matmul`` launches of one request by entry: each edge conv
    and dense layer of the deployed (compacted or masked) network on the
    route its shape picks, from codes where the plan quantizes."""
    import collections
    import torch
    from repro_torch.core.collab.runtime import deploy_submodels
    from repro_torch.kernels.masked_matmul.ops import _route
    _, dcfg, _ = deploy_submodels(plan.params, plan.cfg, plan.masks,
                                  plan.compact)
    dtype = torch.float32 if plan.quant.weight_bits is None else torch.uint8
    return collections.Counter(
        _route(dtype, M, K, N)
        for _, M, K, N in gemm_shapes(dcfg)[:edge_gemm_count(plan)])


#: device kernels grouped by a substring of their name: the port's own
#: kernels, cuBLAS's products, PyTorch's im2col, pooling, elementwise and
#: reduction kernels
KINDS = (("masked_matmul tiles", "masked_matmul_wgmma"),
         ("masked_matmul splitk", "masked_matmul_splitk"),
         ("masked_matmul gemv f32", "masked_matmul_gemv_f32"),
         ("masked_matmul gemv", "masked_matmul_gemv"),
         ("masked_matmul", "masked_matmul_kernel"), ("rmsnorm", "rmsnorm_kernel"),
         ("flash_attention", "flash_kernel"),
         ("ssd_scan chunk states", "ssd_chunk_state"),
         ("ssd_scan state pass", "ssd_state_pass"),
         ("ssd_scan outputs", "ssd_chunk_out"), ("ssd_scan", "ssd_kernel"),
         ("cublas", "nvjet"), ("cublas", "gemm"), ("cublas", "gemv"),
         ("im2col", "im2col"), ("maxpool", "max_pool"),
         ("elementwise", "elementwise"), ("reduce", "reduce"),
         ("copy", "Memcpy"), ("copy", "copy"), ("cat", "Cat"))


def device_profile(fn):
    """Device time by kernel for one call of ``fn`` (which ends in a
    synchronize), against that call's unprofiled host wall-clock, after a
    warm-up call; the first profiler pass, which pays the tracer's
    start-up, is discarded. ``by_kind`` sums the device time over the
    groups of ``KINDS`` (the first whose substring the name holds; "other"
    for the rest)."""
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
    by_kind = {}
    for e in events:
        kind = next((k for k, sub in KINDS if sub in e.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "by_kind": by_kind,
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
def model_setup(cfg, seed: int):
    """``cfg`` at full width on the card: random weights from a seeded CUDA
    generator in the reference's distributions (``init_params`` draws one
    tensor at a time), then random norm scales near 1, QKV and conv biases
    and SSD skip weights ``D`` (the reference initialises them to ones and
    zeros, which would leave the scale, bias and skip paths untested), and
    masks from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit:
    half the KV groups and FFN channels of every attention layer, half the
    SSD heads of every Mamba2 layer."""
    import torch
    from repro_torch.core.pruning.masks import (transformer_masks_from_ratios,
                                                transformer_prunable_units)
    from repro_torch.models import transformer as tr
    params = tr.init_params(cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def fill(t, mean, std):
        t.copy_(mean + std * torch.randn(t.shape, device="cuda",
                                         generator=gen))
    for rp in params["runs"]:
        if "attn" in rp:
            for name in ("bq", "bk", "bv"):
                fill(rp["attn"][name], 0.0, 0.1)
            fill(rp["ln1"], 1.0, 0.1)
            fill(rp["ln2"], 1.0, 0.1)
        else:
            fill(rp["ln1"], 1.0, 0.1)
            fill(rp["ssm"]["norm_scale"], 1.0, 0.1)
            fill(rp["ssm"]["conv_b"], 0.0, 0.1)
            fill(rp["ssm"]["D"], 1.0, 0.1)
    if "shared" in params:
        fill(params["shared"]["ln1"], 1.0, 0.1)
        fill(params["shared"]["ln2"], 1.0, 0.1)
    fill(params["final_norm"], 1.0, 0.1)
    n = len(transformer_prunable_units(cfg))
    masks = transformer_masks_from_ratios(params, cfg, [0.5] * n)
    return params, masks


def describe(cfg, params, masks) -> None:
    """The ``slice`` line naming the model being served."""
    from repro_torch.models.transformer import param_count
    row = {"model": cfg.name, "arch_type": cfg.arch_type,
           "num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
           "params": param_count(params)}
    if cfg.ssm is not None:
        row.update(ssm_heads=cfg.ssm_heads, ssm_head_dim=cfg.ssm.head_dim,
                   d_state=cfg.ssm.d_state, chunk_size=cfg.ssm.chunk_size,
                   kept_ssm_heads_per_layer=float(
                       masks[0]["ssm_head_mask"].sum(1)[0]))
    if cfg.num_heads:
        row.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                   shared_attn_period=cfg.shared_attn_period)
    if masks[0] is not None and "head_mask" in masks[0]:
        row.update(kept_heads_per_layer=float(masks[0]["head_mask"].sum(1)[0]),
                   kept_ffn_per_layer=float(masks[0]["ffn_mask"].sum(1)[0]))
    print("slice " + json.dumps(row), flush=True)


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
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"rmsnorm": rmsnorm, "masked_matmul": masked_matmul,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def expected_launches(cfg):
    """Kernel launches of one request (a prefill and DECODE_STEPS decode
    steps) of ``cfg``'s pruned stack: an attention layer has two pre-norms,
    the masked FFN's up and gate products and (prefill only) one attention;
    a Mamba2 layer one pre-norm and (prefill only) one scan; each invocation
    of a hybrid's shared block two norms and (prefill only) one attention,
    its MLP unmasked; the final norm once a step. The FFN products, by
    ``masked_matmul`` entry: the prefill's (M = B*S rows) on the wgmma
    tiles, the decode steps' (M = B) on the GEMV."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models.transformer import hybrid_split, layer_runs
    steps = 1 + DECODE_STEPS
    attn = sum(r.count for r in layer_runs(cfg) if r.kind != "ssm")
    ssm = cfg.num_layers - attn
    shared = (hybrid_split(cfg, ssm)[0] if cfg.shared_attn_period else 0)
    return {"rmsnorm": (2 * attn + ssm + 2 * shared + 1) * steps,
            "masked_matmul": 2 * attn * steps,
            "flash_attention": attn + shared, "ssd_scan": ssm,
            **dict.fromkeys(masked_matmul.route_launches, 0),
            "masked_matmul_bf16_tiles": 2 * attn,
            "masked_matmul_bf16_gemv": 2 * attn * DECODE_STEPS}


def transformer_slice(cfg, params, masks, requests):
    """Phases 6, 8, 9: each request (label, B, S) through the kernel path
    with the launch counters zeroed just before and read just after; the
    same requests through the plain versions in bf16 and in fp32, teacher-
    forced with the kernel path's tokens; every logit row held to the
    tolerance. Returns the per-request rows and the launch totals."""
    import numpy as np
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    wrappers = transformer_wrappers()
    mm = wrappers["masked_matmul"]
    per_request = expected_launches(cfg)
    rng = np.random.default_rng(SEED)
    requests = [(label, rng.integers(0, cfg.vocab_size, (B, S)))
                for label, B, S in requests]
    kern, totals = {}, dict.fromkeys(per_request, 0)
    for label, tok in requests:
        for w in wrappers.values():
            w.launches = 0
        mm.route_launches = dict.fromkeys(mm.route_launches, 0)
        kern[label] = serve_tokens(cfg, params, masks, tok)
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update(mm.route_launches)
        if counts != per_request:
            raise AssertionError(f"{cfg.name} {label}: launches {counts}, "
                                 f"expected {per_request}")
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
            if g.shape != (B, cfg.padded_vocab) or not bool(
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
        row = {"model": cfg.name, "request": label, "batch": B, "prompt": S,
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
            raise AssertionError(f"{cfg.name} {label}: kernel-path logits "
                                 f"off by {worst} of the tolerance")
        rows.append(row)
    return rows, totals


def profile_transformer(cfg, params, masks):
    """Phases 7 and 10: device time of one R1 prefill and one decode step of
    the kernel path, against their unprofiled wall-clock."""
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


# ---------------------------------------------------------------------------
# phase 11: the socket deployment (AlexNet), both peers on the card
# ---------------------------------------------------------------------------
def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS assigns."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_bits(a, b) -> bool:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def zero_counts():
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    masked_matmul.launches = 0
    masked_matmul.route_launches = dict.fromkeys(
        masked_matmul.route_launches, 0)


def read_counts():
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    return masked_matmul.launches, {
        k: v for k, v in masked_matmul.route_launches.items() if v}


def local_reference(plan, images):
    """Phase 4's local backend on the card: each image's result and wall
    ms (host clock around ``infer``, which ends in a copy to the host)."""
    from repro_torch import serving
    sess = serving.connect(plan, backend="local")
    out, wall = [], []
    for img in images:
        t0 = time.perf_counter()
        out.append(sess.infer(img))
        wall.append(1e3 * (time.perf_counter() - t0))
    return out, wall


def expected_frame(plan, res):
    """What one request through the socket must give, from the local
    backend's result: at an interior split the same logits and
    ``tx_bytes``; at c=N the edge sends the logits themselves, so they
    come back through the plan's codec (as bits, the codec's roundtrip of
    the local logits) and the frame is their encoding."""
    from repro_torch.core.collab.protocol import decode_any, encode_feature
    if plan.split < len(plan.cfg.layers):
        return res["logits"], res["tx_bytes"]
    buf = encode_feature(res["logits"], codec=plan.codec)
    return decode_any(buf)[0], len(buf)


def socket_run(label, plan, images, local, local_wall, faults=None,
               expected_faults: int = 0, profile: bool = False):
    """Phase 11 for one plan: ``CloudServer(plan)`` on 127.0.0.1 and one
    ``connect(plan, "socket")`` session, both on the card in this process;
    the images sent one after another, each request's logits and
    ``tx_bytes`` held, bit for bit, to the local backend's, the
    ``masked_matmul`` launches (all from this thread: the cloud half runs
    no kernel of the port) counted from just before the first request to
    just after the last. With ``profile``, a ``profile`` line follows for
    one more request: both peers' device time against its wall-clock.
    Returns the ``socket`` row."""
    from repro_torch import serving
    with serving.CloudServer(plan, faults=faults) as server:
        with serving.connect(plan, backend="socket") as sess:
            zero_counts()
            got, wall = [], []
            for img in images:
                t0 = time.perf_counter()
                got.append(sess.infer(img))
                wall.append(1e3 * (time.perf_counter() - t0))
            launches, routes = read_counts()
            if profile:
                print("profile " + json.dumps({
                    "path": f"socket {label}", "split": plan.split,
                    **device_profile(lambda: sess.infer(images[0]))}),
                    flush=True)
    for i, (g, w) in enumerate(zip(got, local)):
        want, tx = expected_frame(plan, w)
        if not same_bits(g["logits"], want) or g["tx_bytes"] != tx:
            raise AssertionError(f"socket {label}: request {i} differs from "
                                 f"the local backend (tx {g['tx_bytes']} "
                                 f"against {tx})")
    want_routes = {k: v * len(images) for k, v in edge_routes(plan).items()}
    if launches != edge_gemm_count(plan) * len(images) or \
            routes != want_routes:
        raise AssertionError(f"socket {label}: masked_matmul {launches} "
                             f"launches {routes}, expected {want_routes}")
    n_faults = sum(g["fault"]["faults"] for g in got)
    n_retries = sum(g["fault"]["retries"] for g in got)
    if n_faults != expected_faults or n_retries != expected_faults or \
            any(g["fault"]["fallback"] for g in got):
        raise AssertionError(f"socket {label}: fault records "
                             f"{[g['fault'] for g in got]}")
    row = {"plan": label, "split": plan.split, "requests": len(images),
           "bit_identical_to_local": True, "tx_bytes": got[0]["tx_bytes"],
           "launches": launches, "routes": routes,
           "faults": n_faults, "retries": n_retries,
           "fault_records": [g["fault"] for g in got],
           "server_fault_stats": dict(server.fault_stats),
           "wall_ms": wall,
           "wall_ms_median": statistics.median(wall[1:]),
           "wall_ms_p90": percentile(wall[1:], 90),
           "t_edge_ms_median": 1e3 * statistics.median(
               g["t_edge"] for g in got[1:]),
           "t_upstream_ms_median": 1e3 * statistics.median(
               g["t_upstream"] for g in got[1:]),
           "local_wall_ms_median": statistics.median(local_wall[1:]),
           "local_wall_ms_p90": percentile(local_wall[1:], 90)}
    print("socket " + json.dumps(row), flush=True)
    return row


def socket_batched(plan, images_by_client, local_by_client):
    """Phase 11, batching plan: ``CloudServer(plan)``, one
    ``SocketSession`` per client opened first (its deployment built, its
    HELLO done), then one client sending its images alone (req/s of one
    client) and all of them at once, each from its own thread (req/s of
    the fleet of clients); each row's logits held, bit for bit, to the
    local backend's; the server's lane accounting must show batches of
    more than one row."""
    import threading
    from repro_torch import serving
    got, wall, errors = {}, {}, []

    def client(c, sess, images):
        try:
            got[c], wall[c] = [], []
            for img in images:
                t0 = time.perf_counter()
                got[c].append(sess.infer(img))
                wall[c].append(1e3 * (time.perf_counter() - t0))
        except Exception as e:                           # noqa: BLE001
            errors.append(e)
    with serving.CloudServer(plan) as server:
        sessions = {c: serving.connect(plan, backend="socket")
                    for c in images_by_client}
        first = next(iter(images_by_client))
        t0 = time.perf_counter()
        client(first, sessions[first], images_by_client[first])
        one_s = time.perf_counter() - t0
        solo, solo_wall = got.pop(first), wall.pop(first)
        threads = [threading.Thread(target=client,
                                    args=(c, sessions[c], ims))
                   for c, ims in images_by_client.items()]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        all_s = time.perf_counter() - t0
        for sess in sessions.values():
            sess.close()
    if errors:
        raise errors[0]
    for c, results in [*got.items(), ("alone", solo)]:
        local = local_by_client[first if c == "alone" else c]
        for i, (res, want) in enumerate(zip(results, local)):
            logits, tx = expected_frame(plan, want)
            if not same_bits(res["logits"], logits) or res["tx_bytes"] != tx:
                raise AssertionError(f"socket batched: client {c} request "
                                     f"{i} differs from sequential")
    sizes = [b for lane in server.batch_stats.values()
             for b in lane["batch_sizes"]]
    n = sum(len(ims) for ims in images_by_client.values())
    if max(sizes, default=0) < 2:
        raise AssertionError(f"socket batched: no batch of more than one "
                             f"row ({server.batch_stats})")
    together = [w for ws in wall.values() for w in ws[1:]]
    row = {"plan": "batched", "split": plan.split,
           "max_batch": plan.batching.max_batch,
           "max_wait_ms": plan.batching.max_wait_ms,
           "clients": len(images_by_client), "requests": n,
           "bit_identical_to_sequential": True,
           "req_per_s": n / all_s,
           "one_client_req_per_s": len(solo) / one_s,
           "wall_ms_median": statistics.median(together),
           "wall_ms_p90": percentile(together, 90),
           "one_client_wall_ms_median": statistics.median(solo_wall[1:]),
           "one_client_wall_ms_p90": percentile(solo_wall[1:], 90),
           "rows_served": sum(l["rows"] for l in server.batch_stats.values()),
           "batches": sum(l["batches"] for l in server.batch_stats.values()),
           "batch_sizes": sizes}
    print("socket " + json.dumps(row), flush=True)
    return row


def socket_phase(plans, images):
    """Phase 11: the socket deployment of the int8 compacted AlexNet. c=19
    (every layer on the edge: the logits cross the wire) and c=13 (the
    convs on the edge, the dense layers in the cloud), plain; c=13 with a
    ``batching`` section (4 clients at once); c=13 with a ``faults``
    section and a server that drops one response and corrupts another,
    each recovered by replay. Returns the routes of the counted runs."""
    import dataclasses
    import numpy as np
    from repro_torch.core.collab.channel import FaultInjector
    from repro_torch.core.partition.profiles import FaultEvent, FaultSchedule
    from repro_torch.serving import BatchingPolicy, FaultPolicy

    def on_socket(plan, **sections):
        # loopback without the link shaper: what is measured is the TCP
        # hop, the framing and the threads, not a modelled Wi-Fi link
        return dataclasses.replace(plan, port=free_port(), shape_link=False,
                                   **sections)
    routes = collections.Counter()
    for label in ("greedy", "c13"):
        plan = on_socket(plans[label])
        local, local_wall = local_reference(plan, images)
        routes.update(socket_run(label, plan, images, local, local_wall,
                                 profile=True)["routes"])
    c13 = plans["c13"]
    local, local_wall = local_reference(c13, images)
    faults = FaultInjector(FaultSchedule("drop_and_corrupt", (
        FaultEvent(2, "drop"), FaultEvent(5, "corrupt"))))
    routes.update(socket_run(
        "faults", on_socket(c13, faults=FaultPolicy(
            max_retries=3, backoff_base_s=0.001, request_deadline_s=4.0)),
        images, local, local_wall, faults=faults,
        expected_faults=2)["routes"])
    rng = np.random.default_rng(SEED + 11)
    by_client = {c: [rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
                     for _ in range(REQUESTS)] for c in range(4)}
    batched = on_socket(c13, batching=BatchingPolicy(max_batch=4,
                                                     max_wait_ms=2.0))
    local_by_client = {c: local_reference(batched, ims)[0]
                       for c, ims in by_client.items()}
    socket_batched(batched, by_client, local_by_client)
    return routes


def kernel_entry(name, rows, main_rows, scale: int, launches: int,
                 **extra):
    """One kernel of the JSON line: times and bound summed over
    ``main_rows`` and multiplied by ``scale`` (how often one main-path
    request or prefill launches that shape), the worst error over all its
    checked ``rows``; ``library_ms`` null where no PyTorch call computes
    the function."""
    total = {k: scale * sum(r[k] for r in main_rows)
             for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    library = (None if any(r["library_ms"] is None for r in main_rows)
               else scale * sum(r["library_ms"] for r in main_rows))
    if all("device_ms" in r for r in main_rows):   # from a CUDA graph
        extra["device_ms"] = scale * sum(r["device_ms"] for r in main_rows)
    base = next(k for k in REPLACES if name.startswith(k))
    return {"name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], **extra, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                         else "operations"),
            "library_ms": library}


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
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "arning")):
                print(f"build {name}: {line.strip()}", flush=True)
    check_no_spills("flash_attention", logs["flash_attention"])

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
    # the compacted shapes from int8 codes, as the quantized edge runs them,
    # plus a ragged N (no vector copies) and a partial mask
    rows_q8 = check_masked_matmul_q8(
        full + compacted + [("q8 ragged", 77, 29, 45, "partial"),
                     ("q8 m1 ragged", 1, 300, 50, "partial"),
                     ("q8 partial_mask", 512, 256, 192, "partial")])
    # the float32 GEMV against the split-K tiles at dense14's compacted shape
    dense14 = next(r for r in rows if r["case"] == "dense14 compact")
    f32_gemv_splitk_crossover((1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
                              dense14["K"], dense14["N"])
    # Qwen2-7B: d_model 3584, d_ff 18944, 28 heads / 4 KV heads of 128
    d, dff = 3584, 18944
    # every route and its edges: the GEMV at 1 and 2 rows (and with K and N
    # off its block sizes), the wgmma tiles from 3 rows (3, 8, 9, 16, 64;
    # R2's ragged 2000, R1's 2048; K, N and M off the tile sizes), the
    # CUDA-core tiles for K or N not a multiple of 8; all-zero masks
    rows16 = check_masked_matmul(
        [("ffn prefill R1", 2048, d, dff, "half"),
         ("ffn prefill R2", 2000, d, dff, "half"),
         ("ffn decode R1", 1, d, dff, "half"),
         ("ffn decode R2", 2, d, dff, "half")]
        + [(f"ffn M={M}", M, d, dff, "half") for M in (3, 8, 9, 16, 64)]
        + [("tiles ragged", 200, 3576, 1000, "partial"),
           ("gemv ragged", 2, 1000, 1000, "partial"),
           ("all_zero_mask tiles", 256, 512, 1024, "zeros"),
           ("all_zero_mask gemv", 2, 512, 1024, "zeros"),
           ("ragged", 77, 29, 45, "partial")], dtype="bfloat16")
    gemv_tiles_crossover((1, 2, 3, 4, 8, 16, 64), d, dff)
    launch_host_us(d, dff, dense14["K"], dense14["N"])
    norm_rows = check_rmsnorm(
        [(f"{r} rows {dt} +{off:g}", r, d, dt, off)
         for r in (2048, 2000, 1000) for dt in ("bfloat16", "float32")
         for off in (0.0, 1.0)]
        + [("decode rows 1 bfloat16 +0", 1, d, "bfloat16", 0.0),
           ("decode rows 2 bfloat16 +0", 2, d, "bfloat16", 0.0),
           ("ragged", 3, 77, "bfloat16", 1.0)]
        # Mamba2-2.7B (d_model 2560) and Zamba2-1.2B (2048): prefill and
        # decode rows of R1 and R2
        + [(f"{name} {r} rows bfloat16 +0", r, w, "bfloat16", 0.0)
           for name, w, rs in (("mamba2", 2560, (2048, 2000, 1, 2)),
                               ("zamba2", 2048, (2048, 1)))
           for r in rs])
    flash_rows = check_flash(
        [("prefill R1", 1, 2048, 28, 4, 128, True, None, "bfloat16"),
         ("prefill R2", 2, 1000, 28, 4, 128, True, None, "bfloat16"),
         ("window 512", 1, 2048, 28, 4, 128, True, 512, "bfloat16"),
         ("noncausal", 1, 1000, 28, 4, 128, False, None, "bfloat16"),
         ("window noncausal", 1, 300, 28, 4, 128, False, 40, "bfloat16"),
         ("fp32", 1, 512, 28, 4, 128, True, None, "float32"),
         ("head dim 64", 2, 300, 8, 2, 64, True, None, "bfloat16"),
         ("ragged 77", 1, 77, 28, 4, 128, True, None, "bfloat16"),
         ("zamba2 shared R1", 1, 2048, 32, 32, 64, True, None, "bfloat16"),
         # the large head dims: gemma-7b's R1 (16/16 heads of 256) and
         # nemotron-4-340b's heads (96/8 of 192), ragged and in fp32
         ("gemma-7b R1 D256", 1, 2048, 16, 16, 256, True, None, "bfloat16"),
         ("nemotron R1 D192", 1, 2048, 96, 8, 192, True, None, "bfloat16"),
         ("ragged 77 D256", 1, 77, 16, 16, 256, True, None, "bfloat16"),
         ("ragged 77 D192", 1, 77, 96, 8, 192, True, None, "bfloat16"),
         ("fp32 D256", 1, 512, 16, 16, 256, True, None, "float32"),
         ("fp32 D192", 1, 512, 96, 8, 192, True, None, "float32")])
    # Mamba2-2.7B: 80 heads of 64, d_state 128; Zamba2-1.2B: 64 heads of
    # 64, d_state 64; one B/C group each
    ssd_rows = check_ssd(
        [("mamba2 R1", 1, 2048, 80, 1, 64, 128, "bfloat16", "half"),
         ("mamba2 R2", 2, 1000, 80, 1, 64, 128, "bfloat16", "half"),
         ("zamba2 R1", 1, 2048, 64, 1, 64, 64, "bfloat16", "half"),
         ("groups 2", 1, 512, 8, 2, 64, 128, "bfloat16", "none"),
         ("short 77", 1, 77, 80, 1, 64, 128, "bfloat16", "half"),
         ("s1", 2, 1, 80, 1, 64, 128, "bfloat16", "half"),
         ("all pruned", 1, 300, 16, 1, 64, 64, "bfloat16", "zeros"),
         ("fp32", 1, 1000, 16, 1, 64, 128, "float32", "half"),
         ("fp32 d_state 64", 2, 300, 8, 2, 64, 64, "float32", "none")],
        profile_cases=("mamba2 R1", "zamba2 R1"))
    if kernels_only:
        print(smi, flush=True)
        return 0

    # 4. the AlexNet slice at full width
    images = [rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
              for _ in range(REQUESTS)]
    n = len(cfg.layers)
    plans = {}
    for label, split, compact, bits in (("greedy", None, True, 8),
                                        ("c13", 13, True, 8),
                                        ("cN", n, True, 8),
                                        ("masked_cN", n, False, 8),
                                        ("cN_fp32", n, True, None)):
        plans[label] = serving.DeploymentPlan.from_args(
            params, cfg, split, masks=masks, compact=compact, codec="int8",
            quant=serving.QuantPolicy(weight_bits=bits))
    alex_routes = collections.Counter()
    for label, plan in plans.items():
        alex_routes.update(serve_path(label, plan, images,
                                      edge_gemm_count(plan))["routes"])

    # 5. where one full-width AlexNet request's device time goes
    profile_request(plans["greedy"], images[0])
    profile_request(plans["c13"], images[0])
    torch.cuda.empty_cache()

    # 6. the pruned Qwen2-7B at full width, served by prefill and decode
    from repro_torch.configs import (mamba2_2p7b, qwen2_7b, zamba2_1p2b)
    qcfg = qwen2_7b.CONFIG
    qparams, qmasks = model_setup(qcfg, SEED)
    describe(qcfg, qparams, qmasks)
    _, totals = transformer_slice(qcfg, qparams, qmasks, TRANSFORMER_REQUESTS)

    # 7. where one R1 prefill's and one decode step's device time goes
    profile_transformer(qcfg, qparams, qmasks)
    del qparams
    torch.cuda.empty_cache()

    # 8. the pruned Mamba2-2.7B at full width and depth
    mcfg = mamba2_2p7b.CONFIG
    mparams, mmasks = model_setup(mcfg, SEED)
    describe(mcfg, mparams, mmasks)
    _, mtotals = transformer_slice(mcfg, mparams, mmasks,
                                   TRANSFORMER_REQUESTS)

    # 9. the pruned Zamba2-1.2B (hybrid) at full width and depth
    zcfg = zamba2_1p2b.CONFIG
    zparams, zmasks = model_setup(zcfg, SEED)
    describe(zcfg, zparams, zmasks)
    _, ztotals = transformer_slice(zcfg, zparams, zmasks,
                                   TRANSFORMER_REQUESTS[:1])
    del zparams
    torch.cuda.empty_cache()

    # 10. where one Mamba2 R1 prefill's and one decode step's time goes
    profile_transformer(mcfg, mparams, mmasks)
    del mparams
    torch.cuda.empty_cache()
    for name in totals:
        totals[name] += mtotals[name] + ztotals[name]

    # 11. the socket deployment of the AlexNet plans, both peers on the card
    alex_routes.update(socket_phase(plans, images))

    # times of the kernel line: each float32 / codes masked_matmul route
    # summed over the GEMMs of one c=N request of the compacted AlexNet plan
    # that take it (the convs on the split-K tiles, the dense layers on the
    # GEMV); the bf16 masked_matmul's GEMV over one Qwen2-7B R1
    # decode step (56 products); the other kernels over one R1 prefill of
    # the model that launches them most (Qwen2-7B: 56 FFN products on the
    # wgmma tiles, 57 norms, 28 attentions; Mamba2-2.7B: 64 scans) at the
    # prefill's shapes
    L = qcfg.num_layers

    def case(rs, name):
        return [r for r in rs if r["case"] == name]
    def alex(rs, entry):
        mine = [r for r in rs if r["entry"] == entry]
        return mine, [r for r in mine if r["case"].endswith(" compact")]
    kernels = [
        kernel_entry(entry, *alex(rs, entry), 1, alex_routes[entry],
                     dtype=dtype)
        for rs, dtype in ((rows, "float32"), (rows_q8, "uint8 codes"))
        for entry in (f"masked_matmul_{'q8' if rs is rows_q8 else 'f32'}"
                      f"_{route}" for route in ("splitk", "gemv"))]
    kernels += [
        kernel_entry("masked_matmul_bf16_tiles",
                     [r for r in rows16
                      if r["entry"] == "masked_matmul_bf16_tiles"],
                     case(rows16, "ffn prefill R1"), 2 * L,
                     totals["masked_matmul_bf16_tiles"], dtype="bfloat16"),
        kernel_entry("masked_matmul_bf16_gemv",
                     [r for r in rows16
                      if r["entry"] == "masked_matmul_bf16_gemv"],
                     case(rows16, "ffn decode R1"), 2 * L,
                     totals["masked_matmul_bf16_gemv"], dtype="bfloat16"),
        kernel_entry("rmsnorm", norm_rows,
                     case(norm_rows, "2048 rows bfloat16 +0"), 2 * L + 1,
                     totals["rmsnorm"]),
        kernel_entry("flash_attention", flash_rows,
                     case(flash_rows, "prefill R1"), L,
                     totals["flash_attention"]),
        kernel_entry("ssd_scan", ssd_rows, case(ssd_rows, "mamba2 R1"),
                     mcfg.num_layers, totals["ssd_scan"],
                     passes=case(ssd_rows, "mamba2 R1")[0]["passes_ms"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
