"""Mixture-of-Experts layer with sort-based (dropping) token dispatch — the
reference's ``models/layers/moe.py``.

Dispatch: flatten the (token, k) assignments, sort them by expert id,
place each at its position within its expert in an (E, C, d) buffer
(assignments past the capacity C are dropped), run every expert as one
batched product over the stacked expert weights (``torch.bmm``), then
gather each assignment's row and add it, weighted by its router
probability, into its token's output in float32. The reference computes
all of it outside any Pallas kernel, so the port keeps it in plain PyTorch
ops: ``argsort``, ``bincount``, indexing, ``bmm`` and ``index_add_``.

Expert weights are stacked (E, ...), as in the reference. The
reference's sharding constraints on the dispatch buffer (expert
parallelism on the "model" mesh axis) become the split itself: a
tensor-parallel rank holds its block of experts and builds the buffer of
those only (``moe_forward``'s ``tp``).

Pruning hook: ``expert_mask`` (E,) — pruned experts get a router logit of
-1e30, so the softmax or sigmoid gives them a score of 0 and top-k never
picks one while at least ``top_k`` experts are kept.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models.layers.init import normal, slot
from repro_torch.models.layers.mlp import GATED, _act
from repro_torch.sharding.tensor_parallel import transposed


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor      # load-balance auxiliary loss (scalar)
    z_loss: torch.Tensor        # router z-loss (scalar)
    drop_frac: torch.Tensor     # fraction of assignments dropped


def _init(gen: torch.Generator, shape, dtype, device,
          out=None) -> torch.Tensor:
    return normal(gen, shape, dtype, device, div=math.sqrt(shape[-2]),
                  out=out)


def init_moe_params(gen: torch.Generator, d_model: int, moe, activation: str,
                    dtype: torch.dtype, device: torch.device,
                    out=None) -> Dict[str, torch.Tensor]:
    """The reference's tree and distributions (a float32 router scaled by
    1/sqrt(d_model); expert and shared-expert weights normal over
    sqrt(fan_in)), drawn from ``gen``, so the numbers are the port's own;
    each into its slot of ``out`` where given (``layers.init``)."""
    E, de = moe.num_experts, moe.d_expert

    def draw(name, shape, dt=dtype):
        return _init(gen, shape, dt, device, slot(out, name))
    p = {"w_router": draw("w_router", (d_model, E), torch.float32),
         "w_up": draw("w_up", (E, d_model, de)),
         "w_down": draw("w_down", (E, de, d_model))}
    if activation in GATED:
        p["w_gate"] = draw("w_gate", (E, d_model, de))
    if moe.num_shared:
        ds = de * moe.num_shared
        p["w_up_sh"] = draw("w_up_sh", (d_model, ds))
        p["w_down_sh"] = draw("w_down_sh", (ds, d_model))
        if activation in GATED:
            p["w_gate_sh"] = draw("w_gate_sh", (d_model, ds))
    return p


def capacity(num_tokens: int, moe) -> int:
    """Slots an expert has for ``num_tokens`` tokens: the even share of
    the top-k assignments times the capacity factor, rounded up to a
    multiple of 8, at least 8."""
    c = int(math.ceil(num_tokens * moe.top_k / moe.num_experts
                      * moe.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _scores(params, moe, x2d: torch.Tensor,
            expert_mask: Optional[torch.Tensor]):
    """(router logits float32, scores): the sigmoid or softmax of the
    logits; a pruned expert's logit is -1e30."""
    logits = x2d.to(torch.float32) @ params["w_router"]
    if expert_mask is not None:
        logits = torch.where(expert_mask[None] > 0, logits, -1e30)
    if moe.score_fn == "sigmoid":
        return logits, torch.sigmoid(logits)
    return logits, torch.softmax(logits, dim=-1)


def _router(params, moe, x2d: torch.Tensor,
            expert_mask: Optional[torch.Tensor]):
    """(logits float32, probs (T, k) renormalised over the picked
    experts, idx (T, k))."""
    logits, scores = _scores(params, moe, x2d, expert_mask)
    probs, idx = torch.topk(scores, moe.top_k, dim=-1)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, idx


def _by_expert(idx: torch.Tensor, probs: torch.Tensor, E: int):
    """The (token, k) assignments sorted by expert, stably as
    ``jnp.argsort``: (expert, token, probability, assignments an expert,
    position within the expert), the position following token order."""
    T, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_p = probs.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    # bincount's output length depends on the data; a count of static
    # shape gives the same integers
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    return se, st, sp, counts, pos


def _router_losses(moe, logits: torch.Tensor, idx: torch.Tensor, T: int,
                   batch_sum=None):
    """(aux, z): the Switch-style load-balance loss E * sum_e f_e * p_e and
    the router z-loss, means over ``T`` tokens. ``batch_sum``, where given,
    sums this rank's parts over the ranks whose rows make up the ``T``
    tokens (one all-reduce: assignments an expert, router probability an
    expert, the squared log-partition)."""
    E = moe.num_experts
    sums = torch.cat([
        torch.nn.functional.one_hot(idx, E).to(torch.float32).sum((0, 1)),
        torch.softmax(logits, dim=-1).sum(0),
        (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]])
    if batch_sum is not None:
        sums = batch_sum(sums)
    aux = E * torch.sum((sums[:E] / T) * (sums[E:2 * E] / T)) \
        * moe.router_aux_weight
    return aux, sums[2 * E] / T * moe.router_z_weight


def route(params, moe, x2d: torch.Tensor,
          expert_mask: Optional[torch.Tensor]):
    """x2d (T, d) -> (probs (T,k) float32, idx (T,k), aux, z).

    ``torch.topk`` and ``lax.top_k`` may order equal scores differently.
    The masks of ``core.pruning.masks`` keep at least ``top_k +
    num_shared`` experts, so the masks alone make no tie among the picked
    scores. A tie can still arise from a mask given by hand that keeps
    fewer than ``top_k`` experts (the masked ones all score 0), from
    scores that saturate in float32 (a sigmoid of 1.0 for logits past
    ~17, a softmax that underflows to 0), or from equal router logits (a
    token whose normed input is zero)."""
    logits, probs, idx = _router(params, moe, x2d, expert_mask)
    return (probs, idx) + _router_losses(moe, logits, idx, x2d.shape[0])


def _exchange_plan(local: torch.Tensor, tokens: int, moe, e0: int, C: int,
                   Cb: int, rank: int):
    """What the all-to-all of the kept rows moves, from the counts every
    data rank holds after their all-gather: ``local`` (n, rows, El), the
    assignments each rank's ``tokens`` tokens of a row send to each of this
    rank's experts (one "row" a rank where the rows split, each row where
    the sequence does). An expert's slots go to the (row, rank) blocks in
    that order, each block its consecutive slots; data rank q computes
    slots [q Cb, (q + 1) Cb) below the capacity C.

    Returns (``sizes``: ``sizes[r][q]`` the rows rank r sends rank q, its
    kept rows whose slot lies in q's block; ``at``: where each row this
    rank receives goes in its block, the slot e * Cb + j, in the order the
    rows come: by source, expert, slot). One host read of ``local``.
    Under fake tensors (the dry run) there is nothing to read, and the
    counts are a balanced routing's: each (rank, row, expert) its even
    share of the row's top-k assignments, capped by the capacity."""
    n, R, El = local.shape
    if is_fake(local):
        E, k = moe.num_experts, moe.top_k
        even = tokens * k // E + (np.arange(E) < tokens * k % E)
        counts = np.broadcast_to(even[e0:e0 + El], (n, R, El))
    else:
        counts = local.cpu().numpy()
    seg = counts.transpose(1, 0, 2).reshape(R * n, El)  # (row, rank) order
    ends = np.cumsum(seg, 0)
    lo = np.arange(n) * Cb
    first = np.maximum((ends - seg)[..., None], lo)   # (R * n, El, n)
    cnt = np.clip(np.minimum(ends[..., None], np.minimum(lo + Cb, C))
                  - first, 0, None)
    sizes = cnt.reshape(R, n, El, n).sum((0, 2))

    def here(t):            # rank ``rank``'s column, by (source, expert, row)
        return t[..., rank].reshape(R, n, El).transpose(1, 2, 0).reshape(-1)
    lens = here(cnt)
    starts = here(first - lo[rank] + (np.arange(El) * Cb)[:, None])
    at = np.repeat(starts - (np.cumsum(lens) - lens), lens) \
        + np.arange(lens.sum())
    return sizes.tolist(), at


class _Whole:
    """The share of a layer that holds every expert whole and every row of
    the batch: ``moe_forward`` without a split, each of the split's
    exchanges the identity."""
    data = seq = None

    def __init__(self, moe):
        self.experts = ((0, moe.num_experts), (0, moe.d_expert))

    @staticmethod
    def copy_in(t: torch.Tensor) -> torch.Tensor:
        return t

    reduce = batch_sum = copy_in


def moe_forward(params, moe, x: torch.Tensor, activation: str, *,
                expert_mask: Optional[torch.Tensor] = None, tp=None):
    """x (B, S, d) -> (out (B, S, d), MoEMetrics). ``tp``, where given, is
    a tensor-parallel rank's share (``sharding.tensor_parallel.
    TensorParallel``): ``params`` hold the rank's experts at its columns
    (``tp.experts``) and its shared-expert columns, the router whole; ``x``
    is this rank's rows, the same on every "model" rank. Without ``tp`` the
    layer is whole (``_Whole``) and every exchange below is the identity.

    The reference's semantics over the whole batch: where the data axes
    split the rows (``tp.data``), the capacity is the whole batch's, an
    assignment's position within its expert counts the lower data ranks'
    assignments first (their rows come first; one all-gather of E counts),
    and the balance loss, z-loss and ``drop_frac`` are means over every
    token (``tp.batch_sum``). Where the data axes split the sequence
    instead (``tp.seq``), the lower ranks' tokens come first only within a
    row: an assignment's position counts every token of the earlier rows
    and the same row's tokens on the lower ranks (one all-gather of each
    (row, expert) count). The dispatch buffer is the reference's
    ``eb`` at this rank's experts, its C slots padded to a multiple of the
    data ranks and cut in blocks: data rank q computes slots [q Cb, (q +
    1) Cb) of each expert. Each rank sends each of its kept rows once, to
    the rank whose block holds its slot (``tp.send_rows``: an all-to-all
    over the data axes, the rows by (destination, expert, slot), the sizes
    from the gathered counts, one host read a layer: ``_exchange_plan``);
    the receiver writes them into a zeroed (El, Cb, d) block at the slots
    the same counts give (no index travels), the expert products run on
    the block, and the outputs go back to the rows' ranks by the reverse
    all-to-all. Without data axes the block is the whole buffer, and
    nothing is read to the host.

    The router runs outside the split region on the replicated rows, so
    every rank routes alike and the aux and z losses' gradients count
    once. Two tensors enter the split region through ``copy_in``: the rows
    sent to the experts (and the shared experts), and the combine weights,
    whose gradient on a rank holds only its own experts' share until the
    all-reduce sums them. The combine adds a rank's weighted rows in fp32,
    all-reduces the partial sums over "model" in fp32 and casts; the
    shared experts' row product is reduced on its own, after it."""
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
        # (b, s) order: the earlier rows' tokens (every rank's, less this
        # rank's, which ``pos`` counts), then the same row's lower ranks'
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
    if data is None:
        buf = torch.zeros((N + 1, d), dtype=x.dtype, device=dev)
        buf[slot] = xs[st] * mine_x
        eb = buf[:-1].view(El, Cb, d)
    else:
        # (n, rows, El): each rank's assignments (a row's, on a sequence
        # split) to this rank's experts, in slot order
        local = every[..., e0:e1] if tp.seq is not None \
            else every[:, None, e0:e1]
        sizes, at = _exchange_plan(local, Tl // local.shape[1], moe, e0, C,
                                   Cb, data.rank)
        # this rank's kept rows by (destination, expert, slot): ``slot``'s
        # order
        sent = torch.argsort(slot)[:sum(sizes[data.rank])]
        at = torch.as_tensor(at, device=dev)
        got = tp.send_rows(xs[st[sent]], sizes)
        eb = torch.zeros((El * Cb, d), dtype=x.dtype, device=dev) \
            .index_copy(0, at, got).view(El, Cb, d)
    h = _act(torch.bmm(eb, params["w_up"]), activation)
    if activation in GATED:
        h = h * torch.bmm(eb, params["w_gate"])
    ob = torch.bmm(h, params["w_down"])
    if data is None:
        gathered = ob.reshape(N, d)[slot.clamp(max=N - 1)] * mine_x
    else:
        back = tp.send_rows(ob.reshape(El * Cb, d).index_select(0, at),
                            transposed(sizes))
        gathered = torch.zeros((Tl * k, d), dtype=x.dtype,
                               device=dev).index_copy(0, sent, back)
    out = torch.zeros((Tl, d), dtype=torch.float32, device=dev).index_add_(
        0, st, gathered.to(torch.float32) * sp[:, None])
    out = tp.reduce(out).to(x.dtype)

    if moe.num_shared:
        hs = _act(xs @ params["w_up_sh"], activation)
        if activation in GATED:
            hs = hs * (xs @ params["w_gate_sh"])
        out = out + tp.reduce(hs @ params["w_down_sh"])
    return out.reshape(B, S, d), MoEMetrics(aux, z, drop)
