"""The readings a cell's comparison limits are set from.

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control <name>]

For each seed, in one process: the cell's set-up and a window of
``--seconds``, then the check's numbers for the program and, with
``--control``, for what the mix's module puts in the program's place
under that name: ``precision`` (the reference in the next precision
below the configuration's) or a fault the cell can have
(``half_batch``). One JSON line a seed. The benchmark's runs never run
this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def readings(name: str, seed: int, seconds: float, control=None,
             device: str = "cuda", files=None) -> dict:
    files = files or harness.cell_files(name)
    drv = harness.driver(files["traffic"])
    run = harness.Run(files["cell"], files["config"], files["traffic"],
                      files["limits"], seed, seconds, False, device)
    t0 = time.perf_counter()
    state = drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t0
    run.deadline = time.perf_counter() + seconds
    drv.window(state, run)
    run.sync()
    harness.after_window(drv, state, run)
    drv.free(state)
    t0 = time.perf_counter()
    out = {"seed": seed, "setup_s": setup_s, "attempted": run.attempted,
           "program": drv.check(state, run)}
    out["check_s"] = time.perf_counter() - t0
    if control:
        out[control] = drv.check(state, run, control=control)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None)
    args = ap.parse_args()
    import torch
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.control)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    harness.env_for_checkout()
    sys.exit(main())
