"""Learning-rate schedules (the JAX package's ``optim/schedules.py``).
``step_lr`` is the paper's setup (§4.1): lr0=0.01, gamma=0.1 every 20
epochs. Each schedule maps an optimizer step to the learning rate as a
float32 scalar tensor on the CPU, computed in float32 as the reference
computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(lr: float):
    def sched(step):
        return _f32(lr)
    return sched


def step_lr(lr0: float = 0.01, gamma: float = 0.1, step_size: int = 20,
            steps_per_epoch: int = 1):
    """StepLR in epochs, evaluated per optimizer step (paper §4.1)."""
    def sched(step):
        epoch = int(step) // steps_per_epoch
        return _f32(lr0) * _f32(gamma) ** _f32(epoch // step_size)
    return sched


def cosine_warmup(lr0: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr0 * warm * cos
    return sched
