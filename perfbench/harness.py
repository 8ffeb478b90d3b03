"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, and the result line.

The cell names its configuration and its traffic mix in
``BENCHMARK.json``. The configuration is ``configs/<config>.json``, the
mix ``traffic/<traffic>.json``, whose ``driver`` key names the module of
``drivers/`` that runs that kind of mix; the cell's comparison limits are
``workloads/<cell>.json``. A per-layer metric is read by
``metrics/<name before the first dot>.py``. Adding a cell, a
configuration, a mix or a metric adds files and entries; nothing here
names one.

A driver module has ``setup(run) -> state`` (everything up to the first
timed operation, every shape of the cell warmed), ``window(state, run)``
(the closed loop until ``run.deadline``, traced whole in a traced run),
``end_to_end(state, run)``,
``per_layer(state, run)`` (what the readers read, put in
``run.record``), ``free(state)`` (drops the program's state) and
``check(state, run) -> {name: value}`` (the reference's comparison, run
after ``free``); optionally ``after_window(state, run)`` (what the check
needs taken from the program's state as the window left it, run once the
window has closed and the memory peak has been read).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """One run's arguments, its cell's files and what it records."""

    def __init__(self, cell: dict, config: dict, traffic: dict,
                 limits: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda") -> None:
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.deadline = float("inf")
        self.attempted = 0
        self.record: Dict[str, object] = {}

    @property
    def trace_seconds(self) -> float:
        """The length of the traced part of the window."""
        return min(self.seconds, self.traffic.get("trace_seconds",
                                                  self.seconds))

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name``'s entry of ``BENCHMARK.json`` and its files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return {"bench": bench, "cell": cell,
            "config": load_json(ROOT / configs[cell["config"]]["file"]),
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "workloads" / f"{name}.json")}


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def reader(metric: str):
    """The reader module of a per-layer metric (its name up to the first
    dot), loaded from its file."""
    kind = metric.split(".")[0]
    path = BENCH_DIR / "metrics" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of ``section`` the cell reports: an end-to-end metric
    that lists the cell or lists none; a per-layer metric that lists the
    cell, or lists none and moves an end-to-end metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def refuse_forbidden(stage: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"perfbench: {stage}: forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)


def compare(values: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each compared number beside its limit (``limits["checks"]``)."""
    out = {}
    for name, value in values.items():
        limit = limits["checks"][name]
        out[name] = {"value": value, "limit": limit}
    missing = set(limits["checks"]) - set(values)
    if missing:
        raise RuntimeError(f"the check gave no {sorted(missing)}")
    return out


def after_window(drv, state, run: Run) -> None:
    hook = getattr(drv, "after_window", None)
    if hook is not None:
        hook(state, run)
        run.sync()


def execute(run: Run, drv, bench: dict, t_start: float) -> dict:
    """Everything from set-up to the result's dict (without ``device``),
    on ``run.device``."""
    import torch
    state = drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    tracer = None
    if run.trace:
        from perfbench.lib.trace import Tracer
        tracer = Tracer(run.device)
    with tracer or contextlib.nullcontext():
        run.deadline = time.perf_counter() + (run.trace_seconds if run.trace
                                              else run.seconds)
        drv.window(state, run)
        run.sync()
    peak = (torch.cuda.max_memory_allocated() if run.device != "cpu"
            else 0)
    after_window(drv, state, run)
    name = run.cell["name"]
    metrics: Dict[str, dict] = {}
    # a request that fails raises and ends the run: none fails in one
    # that prints a result
    out = {"attempted": run.attempted, "failed": 0,
           "memory_peak_bytes": peak}
    if run.trace:
        run.record["trace"] = tracer.summary
        drv.per_layer(state, run)
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"]).read(run.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        from perfbench.lib.trace import breakdown
        out["busy_s"] = tracer.summary["busy_s"]
        out["window_s"] = tracer.summary["window_s"]
        out["breakdown"] = breakdown(tracer.summary)
    else:
        values = dict(drv.end_to_end(state, run), setup_s=setup_s)
        for m in metrics_of(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    drv.free(state)
    if run.device != "cpu":
        torch.cuda.empty_cache()
    out["metrics"] = metrics
    t_check = time.perf_counter()
    out["checks"] = compare(drv.check(state, run), run.limits)
    print(f"perfbench: set-up {setup_s:.1f} s, window "
          f"{t_check - t_start - setup_s:.1f} s, check "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(args.workload)
    import torch
    chips = files["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    run = Run(files["cell"], files["config"], files["traffic"],
              files["limits"], args.seed, args.seconds, bool(args.trace))
    out = execute(run, driver(files["traffic"]), files["bench"], t_start)
    refuse_forbidden("after the window")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if run.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if run.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def env_for_checkout() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths; keep libraries from loading JAX; run the host's math on one
    thread a library (the work is the card's; pools of spinning threads
    only contend with the program's own threads)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
