"""Small versions of the benchmark's cells for the CPU tests: each cell's
files with its configuration and traffic cut down, run through the
harness on the CPU."""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import harness

LM_TINY = {"hidden_size": 256, "intermediate_size": 512,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "num_hidden_layers": 2, "vocab_size": 4096}
#: per cell: configuration keys, traffic keys, the check's keys (enough
#: served tokens that the control's flips show at this size)
TINY = {
    "qwen2-7b.prefill-replay": (LM_TINY, {"lengths": [16, 24],
                                          "pool_cycles": 8},
                                {"sample_requests": 64}),
    "qwen2-7b.decode-b64": (LM_TINY, {"batch": 3, "prompt": 16,
                                      "max_len": 64, "prefill_rows": 2},
                            {}),
    "alexnet-pv38.stream-c13": ({}, {"pool": 24, "burst": 12,
                                     "microbatch": 4}, {}),
    "alexnet-pv38.finetune-b128": ({"input_hw": [64, 64]},
                                   {"pool": 8, "batch": 2}, {}),
}


def files(cell: str) -> dict:
    f = harness.cell_files(cell)
    cfg, traffic, limits = TINY[cell]
    f["config"] = dict(f["config"], **cfg)
    f["traffic"] = dict(f["traffic"], **traffic)
    f["limits"] = dict(f["limits"], **limits)
    return f


def run_cell(cell: str, seed: int = 2**31 + 11, seconds: float = 0.3,
             trace: bool = False, f=None) -> dict:
    """The harness's run of the tiny cell on the CPU (no look for a card)."""
    f = f or files(cell)
    run = harness.Run(f["cell"], f["config"], f["traffic"], f["limits"],
                      seed, seconds, trace, device="cpu")
    return harness.execute(run, harness.driver(f["traffic"]), f["bench"],
                           time.perf_counter())


class Clock:
    """A clock that advances a millisecond a reading: the window does
    the same work however loaded the machine is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


@contextlib.contextmanager
def threads(n: int = 1):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
