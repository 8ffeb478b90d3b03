"""Resumable driver for the full dry-run matrix (the JAX package's
``launch/dryrun_matrix.py``).

Runs every supported (arch x shape x mesh) combination as a SUBPROCESS
(so one failing trace cannot take down the sweep), single mesh first and
smallest estimated cost first, skipping cells whose
``torch_<arch>_<shape>_<mesh>.json`` record already says ``"ok"``. Each
subprocess is ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M``.

The reference retries a failed compile with ``--scan`` (scan over layers,
which XLA compiles faster but counts once); the port traces a Python loop
and has nothing to retry with, so a failure is recorded as it is.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_matrix [--mesh pod|multipod|both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun_matrix --summary

``--summary`` prints the records as markdown tables, a cell each: per-card
FLOPs beside their ratio to the reference's yardstick (``model_flops``
over the cards: what a card would compute if the work split evenly),
bytes accessed (unfused), collective bytes by op, the dominant term, the
peak and whether it fits a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.specs import SHAPES, mode_of, supported

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")


def est_cost(arch: str, shape: str) -> float:
    """Rough trace-cost order: the reference's unrolled-size proxy."""
    cfg = get_config(arch)
    per_layer = cfg.d_model / 1024
    if cfg.moe is not None:
        per_layer *= 1 + cfg.moe.num_experts / 16
    mode = mode_of(shape)
    S, B = SHAPES[shape]
    tok = {"train": 3.0 * S * B, "prefill": S * B, "decode": B}[mode]
    return cfg.num_layers * per_layer * (1 + tok / 2**20)


def todo(meshes, out_dir: str):
    """[(cost, arch, shape, mesh)] of the cells without an ``ok`` record,
    single mesh first, then by cost."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if not supported(cfg, shape)[0]:
                continue
            for mesh in meshes:
                fn = os.path.join(out_dir, f"torch_{arch}_{shape}_{mesh}.json")
                if os.path.exists(fn):
                    try:
                        with open(fn) as f:
                            if json.load(f).get("status") == "ok":
                                continue
                    except (OSError, ValueError):
                        pass
                cells.append((est_cost(arch, shape), arch, shape, mesh))
    cells.sort(key=lambda t: (t[3] != "pod", t[0]))
    return cells


_OPS = (("all-gather", "AG"), ("reduce-scatter", "RS"),
        ("all-reduce", "AR"), ("all-to-all", "A2A"),
        ("collective-permute", "CP"))


def _cell(rec) -> str:
    """One record as a table cell: per-card FLOPs (and their ratio to
    ``model_flops`` over the cards), unfused bytes, collective bytes by
    op, the dominant term, the peak (with a mark where it does not fit)."""
    roof, coll = rec["roofline"], rec["collectives"]["bytes_by_op"]
    ratio = (f" ({roof['flops'] * rec['chips'] / rec['model_flops']:.0f}x)"
             if rec.get("model_flops") else "")
    moved = " ".join(f"{short} {coll[op]:.2g}" for op, short in _OPS
                     if coll.get(op))
    peak = rec["memory_analysis"]["peak_bytes_per_card"] / 1e9
    return (f"{roof['flops']:.2g}{ratio}; {roof['hbm_bytes']:.2g} B; "
            f"{moved}; {roof['dominant']}; {peak:.0f} GB"
            + ("" if rec["memory_analysis"]["fits"] else " (over)"))


def summary(out_dir: str) -> str:
    """The ``ok`` records of ``out_dir`` as markdown tables, one a mesh
    (a row an arch, a column a shape), one of the split serves and one of
    the train steps in microbatches (``grad_accum`` > 1)."""
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("torch_") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            if rec.get("status", "ok") == "ok":
                recs.append(rec)
    accum = [r for r in recs if r.get("grad_accum", 1) > 1]
    recs = [r for r in recs if r.get("grad_accum", 1) == 1]
    out = []
    for mesh in dict.fromkeys(r["mesh"] for r in recs if "shape" in r):
        out += [f"| {mesh} | " + " | ".join(SHAPES) + " |",
                "|---" * (len(SHAPES) + 1) + "|"]
        for arch in ARCH_IDS:
            cells = {r["shape"]: _cell(r) for r in recs
                     if r["mesh"] == mesh and r.get("arch") == arch
                     and "shape" in r}
            out.append(f"| {arch} | " + " | ".join(
                cells.get(shape, "skipped") for shape in SHAPES) + " |")
        out.append("")
    splits = [r for r in recs if r.get("mode") == "split_serve"]
    if splits:
        out += ["| split serve | mesh | FLOPs; bytes; collectives; "
                "dominant; peak | the reference's hop: 1 / |",
                "|---|---|---|---|"]
        out += [f"| {r['arch']} | {r['mesh']} | {_cell(r)} | "
                f"{r['hop']['activation_shards_in_reference']} |"
                for r in splits]
    if accum:
        out += ["", "| in microbatches | mesh | grad_accum | data_split | "
                "FLOPs; bytes; collectives; dominant; peak |",
                "|---|---|---|---|---|"]
        out += [f"| {r['arch']} {r['shape']} | {r['mesh']} | "
                f"{r['grad_accum']} | {r['data_split']} | {_cell(r)} |"
                for r in accum]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--timeout", type=int, default=2100)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--summary", action="store_true",
                    help="print the records as a markdown table")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.out))
        return
    meshes = {"pod": ["pod"], "multipod": ["multipod"],
              "both": ["pod", "multipod"]}[args.mesh]
    cells = todo(meshes, args.out)
    print(f"{len(cells)} runs queued", flush=True)
    failures = []
    for cost, arch, shape, mesh in cells:
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", args.out]
        print(f">>> {arch} {shape} {mesh} (est {cost:.0f})", flush=True)
        try:
            r = subprocess.run(cmd, timeout=args.timeout,
                               capture_output=True, text=True)
            status = "ok" if r.returncode == 0 else "FAIL"
            if status == "FAIL":
                print(r.stdout[-1500:], r.stderr[-3000:], flush=True)
        except subprocess.TimeoutExpired:
            status = "TIMEOUT"
        if status != "ok":
            failures.append((arch, shape, mesh))
        print(f"<<< {arch} {shape} {mesh}: {status} "
              f"({time.time() - t0:.0f}s)", flush=True)
    print("failures:", failures, flush=True)


if __name__ == "__main__":
    main()
