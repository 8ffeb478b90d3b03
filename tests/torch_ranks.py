"""Helpers of the port's gloo tests that spawned ranks import too, so no
JAX here.

* ``spawn``: ``mp.start_processes`` with a deadline. A rank that hangs on
  a collective (its peer died, or never called it) would hold the test
  worker until gloo's own timeout; here each rank's group times out at
  ``GROUP_TIMEOUT`` (``init_group``) and the spawn as a whole at its
  ``deadline``, past which the ranks are killed and the fixture fails.
* ``slot_exchange``: the MoE dispatch over the data axes as the port
  computed it before the all-to-all of the kept rows — every rank writes
  its kept rows into a buffer of every data rank's slots, zeros
  elsewhere, a reduce-scatter gives each rank its block, and an
  all-gather returns every block's outputs. The tests hold the
  all-to-all's results to this exchange's, bit for bit.
"""
from __future__ import annotations

import contextlib
import datetime
import time
from typing import Optional

import torch
import torch.multiprocessing as mp

#: how long a rank's gloo collective may wait for its peers
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def init_group(rank: int, world: int, port: int) -> None:
    """A gloo group of ``world`` ranks on 127.0.0.1:``port`` whose
    collectives time out at ``GROUP_TIMEOUT``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)


def spawn(fn, args: tuple, nprocs: int, deadline: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, joined until
    all end; a rank's exception fails the caller at once. Past
    ``deadline`` seconds every rank still running is killed and the
    caller fails with ``TimeoutError``."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs,
                             start_method="spawn", join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{nprocs} ranks of {fn.__name__} still ran "
                               f"after {deadline} s: killed")


class _ScatterSlots(torch.autograd.Function):
    """(size, ...) -> this rank's entry of the sum over the data axes
    (reduce-scatter); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, data):
        ctx.data = data
        return data.reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.data.all_gather(g), None


def slot_exchange_moe_forward(params, moe, x: torch.Tensor, activation: str,
                              *, expert_mask: Optional[torch.Tensor] = None,
                              tp=None):
    """``models.layers.moe.moe_forward`` with the slot buffer's
    reduce-scatter and the outputs' all-gather over the data axes (the
    module docstring): the same routes, slots, drops and products."""
    from repro_torch.models.layers.mlp import GATED, _act
    from repro_torch.models.layers.moe import (MoEMetrics, _by_expert,
                                               _router, _router_losses,
                                               _Whole, capacity)
    from repro_torch.sharding.tensor_parallel import all_gather_grad
    tp = _Whole(moe) if tp is None else tp
    B, S, d = x.shape
    Tl = B * S
    dev = x.device
    data = tp.data
    n = 1 if data is None else data.size
    T = n * Tl
    E, k = moe.num_experts, moe.top_k
    x2d = x.reshape(Tl, d)
    logits, probs, idx = _router(params, moe, x2d, expert_mask)
    aux, z = _router_losses(moe, logits, idx, T, tp.batch_sum)
    C = capacity(T, moe)
    se, st, sp, counts, pos = _by_expert(idx, probs, E)
    if data is not None and tp.seq is not None:
        row = st // S
        mine = torch.zeros(B * E, dtype=torch.long, device=dev).scatter_add_(
            0, row * E + se, torch.ones_like(se)).view(B, E)
        every = data.all_gather(mine)                       # (n, B, E)
        rows = every.sum(0)
        before = (torch.cumsum(rows, 0) - rows) - (torch.cumsum(mine, 0)
                                                   - mine)
        pos = pos + (before + every[:data.rank].sum(0))[row, se]
        counts = rows.sum(0)
    elif data is not None:
        every = data.all_gather(counts)                     # (n, E)
        pos = pos + every[:data.rank].sum(0)[se]
        counts = every.sum(0)
    keep = pos < C
    drop = 1.0 - torch.minimum(counts, torch.tensor(C, device=dev)).sum() \
        .to(torch.float32) / (T * k)

    (e0, e1), _ = tp.experts
    El, Cb = e1 - e0, -(-C // n)
    N = n * El * Cb
    mine = keep & (se >= e0) & (se < e1)
    slot = torch.where(mine, ((pos // Cb) * El + se - e0) * Cb + pos % Cb, N)
    mine_x = mine[:, None].to(x.dtype)
    xs, sp = tp.copy_in(x2d), tp.copy_in(sp)
    buf = torch.zeros((N + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xs[st] * mine_x
    eb = buf[:-1].reshape(n, El, Cb, d)
    eb = eb[0] if data is None else _ScatterSlots.apply(eb, data)
    h = _act(torch.bmm(eb, params["w_up"]), activation)
    if activation in GATED:
        h = h * torch.bmm(eb, params["w_gate"])
    ob = torch.bmm(h, params["w_down"])
    ob = ob[None] if data is None else all_gather_grad(ob, data)
    gathered = ob.reshape(N, d)[slot.clamp(max=N - 1)] * mine_x
    out = torch.zeros((Tl, d), dtype=torch.float32, device=dev).index_add_(
        0, st, gathered.to(torch.float32) * sp[:, None])
    out = tp.reduce(out).to(x.dtype)

    if moe.num_shared:
        hs = _act(xs @ params["w_up_sh"], activation)
        if activation in GATED:
            hs = hs * (xs @ params["w_gate_sh"])
        out = out + tp.reduce(hs @ params["w_down_sh"])
    return out.reshape(B, S, d), MoEMetrics(aux, z, drop)


@contextlib.contextmanager
def slot_exchange():
    """The stack's MoE layers on ``slot_exchange_moe_forward`` while the
    context is open."""
    from repro_torch.models import transformer as tr
    real = tr.moe_forward
    tr.moe_forward = slot_exchange_moe_forward
    try:
        yield
    finally:
        tr.moe_forward = real
