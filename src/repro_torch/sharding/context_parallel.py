"""Context parallelism over the data axes for serving and training: the
sequence split the reference's layout asks for where a batch's rows do
not divide the data axes.

The reference's ``batch_specs`` shards a batch's sequence over the data
axes when its rows do not divide them (``sharding/specs.py``), its
``cache_specs`` lays the KV and MLA caches' slots over "data", and its pod
stage keeps a microbatch as ``P(None, "data", "model")``. GSPMD then
computes the same function on that layout, inserting whatever
communication each op needs. The port's kernels take plain tensors, so a
rank computes its block and the exchanges are explicit, each through the
data seam (``axis``: a ``tensor_parallel.DataAxes`` of the mesh's data
groups, or one rank of ``tensor_parallel.SequentialRanks`` in one
process), each standing for what GSPMD does at that op:

* **The block.** Data rank r of n holds positions [r S/n, (r + 1) S/n)
  of every row (``SeqSplit.block``): the sharded sequence dim itself.
* **Attention.** A block's queries attend the keys of every position
  before them: K and V (MLA: its latents) are all-gathered over the data
  axes, cut to the positions the block's causal (and window) mask can
  reach (``SeqSplit.keys``), and the flash kernel runs with the block's
  ``q_offset``: GSPMD's all-gather of the key operand of a
  sequence-sharded attention.
* **The cache.** Each cache leaf's slots (``max_len``, or the rolling
  window's ``cache_len``) lie in n blocks over the data axes where n
  divides them, else whole on every rank, as ``cache_specs`` lays them
  out. The split owns that layout (``SeqSplit.kv`` and
  ``SeqSplit.latent``, each a ``Slots``), decided once from the global
  ``max_len`` when the split is made: the prefill places its leaves by
  it, and the decode step's split, made from the cache's global
  ``max_len`` (``cache_max_len``), reads them by it. The prefill takes
  each rank's slots from the gathered keys (``cache_slots``): nothing
  more moves. A decode step's new slot is written by the rank that owns
  it alone; every rank scores the query against its slots, and the
  partial softmaxes (max, sum, accumulator) are all-gathered and
  combined in rank order (``SeqSplit.combine``), so every rank holds the
  same bits: GSPMD's reduction of a contraction over a sharded dim. A
  rank with no valid slot joins with max = -inf and sum = 0 (every rank
  makes the same collective calls) and adds nothing.
* **The SSD scan** (``SeqSplit.ssd_carry``). Each block is scanned from a
  zero state; the blocks' final states and total decays exp(sum dt A) are
  all-gathered and folded in rank order into each block's incoming
  state, whose part C_t . (exp(cumsum dt A)_t h_in) is added to the
  block's outputs; every rank holds the whole sequence's final state
  (``cache_specs`` replicates it at a batch that does not divide the data
  axes). GSPMD's counterpart is the scan's carry across the sharded dim.
* **The causal conv** (``SeqSplit.halo``): each block takes the last
  ``d_conv - 1`` raw rows before it from the ranks below (zeros on rank
  0), the halo exchange GSPMD makes for a windowed op on a sharded dim;
  every rank keeps the sequence's last rows as the conv tail.
* **The last position** (``SeqSplit.last``): the last rank's hidden
  state, all-gathered and taken whole, the same bits on every rank.
* **Training.** Every exchange of a block's positions is differentiable:
  each all-gather's backward reduce-scatters the gradient over the data
  axes (``tensor_parallel.all_gather_grad``), so the part of dK and dV
  (MLA's latents) that a later block's queries put on a key goes back to
  the rank that holds it, the halo's and the conv tail's gradient to the
  ranks whose rows they were, the folded SSD states' and log-decays' to
  the ranks below. The ranks make the same collective calls in the
  backward as in the forward: rank 0's halo (zeros) and its zero
  incoming state stay in its graph. Each rank's cross-entropy is its
  block's (``transformer.loss_fn`` cuts the labels as the inputs), its
  loss weighted by its share of the labelled tokens (``label_share``),
  so the gradients summed over the data axes (the FSDP gather's
  reduce-scatter) are the whole batch's; the router, z and MTP losses are
  the whole sequence's (``TensorParallel.batch_sum``). Under
  ``torch.no_grad`` every exchange computes what it did for serving
  alone, to the bit.

On one data rank no ``SeqSplit`` is made: the steps are the unsharded
ones.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.tensor_parallel import all_gather_grad


def data_split(rows: int, seq: int, n: int) -> str:
    """How a step of ``rows`` rows of ``seq`` positions lies over ``n``
    data ranks, the reference's ``batch_specs``: ``"rows"`` where the rows
    divide them, else ``"sequence"`` where the positions do, else
    ``"whole"`` (every rank holds everything; also on one rank)."""
    if n > 1 and rows % n == 0:
        return "rows"
    if n > 1 and seq % n == 0:
        return "sequence"
    return "whole"


class Slots(NamedTuple):
    """How a cache leaf's slots lie over the data ranks (``cache_specs``'
    rule): ``count`` of them over every rank; in blocks where the ranks
    divide them (``split``; this rank's are ``lo`` .. ``hi``), else all of
    them on every rank (``lo``, ``hi`` = 0, ``count``)."""
    count: int
    lo: int
    hi: int
    split: bool


def cache_max_len(cache) -> Optional[int]:
    """The ``max_len`` a mesh prefill's cache (a DTensor tree) was made
    at, from its attention leaves' global slots: the shared block's, else
    the first attention run's (a window config's ``cache_len``, which
    gives a ``SeqSplit`` the same layout), None without attention
    leaves."""
    if "shared" in cache:
        return cache["shared"].k.shape[2]
    for rc in cache["runs"]:
        if not hasattr(rc, "state"):
            return rc[0].shape[2]
    return None


class SeqSplit:
    """One data rank's share of a sequence split: ``axis`` the data seam
    (``rank``, ``size``, ``all_gather``); ``tokens`` whether the step's
    positions are split (a prefill's or a pod stage's; a decode step's one
    token is every rank's). Given the cache's ``max_len`` (and ``cfg``),
    the split owns the cache's layout: ``kv`` the ``Slots`` of a KV leaf
    (a run's ``cache_len_for`` ``max_len``, and the shared block's: a
    hybrid has no window), ``latent`` those of an MLA leaf (``max_len``);
    both None without a cache (a pod stage)."""

    def __init__(self, axis, tokens: bool = True, cfg=None,
                 max_len: Optional[int] = None):
        self.axis, self.tokens, self.max_len = axis, tokens, max_len
        self.n, self.rank = axis.size, axis.rank
        self.kv = self.latent = None
        if max_len is not None:
            window = cfg.sliding_window
            if window is not None and cfg.shared_attn_period:
                raise ValueError(f"{cfg.name}: a shared block's slots under "
                                 f"a window are not split")
            self.kv = self._slots(max_len if window is None
                                  else min(max_len, window))
            self.latent = self._slots(max_len)

    def _slots(self, count: int) -> Slots:
        if count % self.n:
            return Slots(count, 0, count, False)
        local = count // self.n
        return Slots(count, self.rank * local, (self.rank + 1) * local,
                     True)

    # -- positions ------------------------------------------------------------
    def block(self, local: int) -> Tuple[int, int]:
        """(lo, hi) of this rank's positions, each rank holding ``local``."""
        return self.rank * local, (self.rank + 1) * local

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t``'s whole sequence on ``dim``."""
        S = t.shape[dim]
        if S % self.n:
            raise ValueError(f"{S} positions do not split over {self.n} "
                             f"data ranks")
        lo, hi = self.block(S // self.n)
        return t.narrow(dim, lo, hi - lo)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``t`` joined in rank order on ``dim``; the
        backward reduce-scatters the gradient over the data axes, each
        block's part back to the rank whose block it was."""
        return torch.cat(all_gather_grad(t, self.axis).unbind(0), dim=dim)

    def keys(self, offset: int, local: int, causal: bool,
             window: Optional[int]) -> Tuple[int, int]:
        """(lo, hi) of the key positions the queries at ``offset`` ..
        ``offset + local - 1`` can see: up to the block's end where
        ``causal`` (all of them where not), from ``window - 1`` before its
        start where there is a window."""
        if not causal:
            return 0, self.n * local
        lo = 0 if window is None else max(0, offset - window + 1)
        return lo, offset + local

    def last(self, t: torch.Tensor) -> torch.Tensor:
        """The last rank's ``t`` on every rank (its bits)."""
        return self.axis.all_gather(t)[-1]

    # -- the cache ------------------------------------------------------------
    def cache_slots(self, t: torch.Tensor, lay: Slots,
                    dim: int) -> torch.Tensor:
        """This rank's slots (``lay``) of the cache a prefill of ``t``'s
        positions (the whole sequence on ``dim``) writes: slot p holds
        position p (zeros past the sequence) where the slots hold them
        all, else the rolling window's slot p % count holds the latest
        such position."""
        S = t.shape[dim]
        lo, hi = lay.lo, lay.hi
        if lay.count >= S:
            part = t.narrow(dim, min(lo, S), max(min(hi, S) - lo, 0))
            if part.shape[dim] == hi - lo:
                return part
            shape = list(t.shape)
            shape[dim] = hi - lo - part.shape[dim]
            return torch.cat([part, t.new_zeros(shape)], dim=dim)
        s = torch.arange(lo, hi, device=t.device)
        return t.index_select(dim, s + lay.count * ((S - 1 - s) // lay.count))

    @staticmethod
    def owner_write(cache: torch.Tensor, slot: torch.Tensor,
                    new: torch.Tensor, lay: Slots) -> None:
        """Write ``new`` (B, ...) at each row's global ``slot`` (B,) of a
        cache leaf (B, this rank's slots of ``lay``, ...), in place, on the
        rank that owns the slot alone (static shapes: the other rows keep
        what they hold)."""
        rows = torch.arange(cache.shape[0], device=cache.device)
        at = (slot - lay.lo).clamp(0, lay.hi - lay.lo - 1)
        own = ((slot >= lay.lo) & (slot < lay.hi)).view(
            (-1,) + (1,) * (new.dim() - 1))
        cache[rows, at] = torch.where(own, new.to(cache.dtype),
                                      cache[rows, at])

    # -- the partial softmax --------------------------------------------------
    def combine(self, m: torch.Tensor, l: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
        """The softmax-weighted sum over every rank's slots from each
        rank's ``partial_softmax`` parts: m and l (...), acc (..., D), all
        float32; one all-gather, the ranks' parts added in rank order."""
        got = self.axis.all_gather(torch.cat([acc, m[..., None],
                                              l[..., None]], -1))
        ms, ls, accs = got[..., -2], got[..., -1], got[..., :-2]
        big = ms.amax(0)
        big = torch.where(torch.isfinite(big), big, torch.zeros_like(big))
        num, den = None, None
        for r in range(self.n):
            w = torch.exp(ms[r] - big)
            num = w[..., None] * accs[r] if num is None \
                else num + w[..., None] * accs[r]
            den = w * ls[r] if den is None else den + w * ls[r]
        return num / den.clamp_min(1e-37)[..., None]

    # -- Mamba2 ---------------------------------------------------------------
    def halo(self, raw: torch.Tensor, width: int):
        """(halo, tail) of a block's raw conv inputs ``raw`` (B, local,
        C): the ``width`` rows before this block (zeros before the
        sequence) and the sequence's last ``width`` rows (every rank's),
        from one all-gather of each rank's last rows; the backward
        reduce-scatters their gradient to the ranks whose rows they were
        (rank 0's halo, all zeros, still joins it)."""
        B, L, C = raw.shape
        w = min(L, width)
        got = all_gather_grad(raw[:, L - w:], self.axis)       # (n,B,w,C)
        rows = torch.cat([raw.new_zeros((B, width, C)),
                          got.transpose(0, 1).reshape(B, self.n * w, C)],
                         dim=1)
        lo = self.rank * w
        return rows[:, lo:lo + width], rows[:, self.n * w:]

    def ssd_carry(self, y: torch.Tensor, state: torch.Tensor,
                  dt: torch.Tensor, A: torch.Tensor, Ch: torch.Tensor,
                  head_mask: Optional[torch.Tensor]):
        """(y with the incoming state's part added, the whole sequence's
        final state): ``y`` (B, local, H, P) and ``state`` (B, H, P, N)
        the block's scan from a zero state, ``dt`` (B, local, H) float32,
        ``A`` (H,), ``Ch`` (B, local, H, N) each head's C. The blocks'
        states and log-decays sum(dt A) are all-gathered and folded in
        rank order; the part C_t . (exp(cumsum dt A)_t h_in) is float32
        and masked by ``head_mask`` as the scan's output is. The backward
        reduce-scatters the folded states' and log-decays' gradient to the
        ranks whose blocks they were; under autograd rank 0 adds a zero
        part, so that its backward joins that reduce-scatter."""
        B, H = state.shape[:2]
        f32 = torch.float32
        cum = torch.cumsum(dt.to(f32) * A.to(f32), dim=1)   # (B, local, H)
        got = all_gather_grad(torch.cat(
            [state.reshape(B, H, -1).to(f32), cum[:, -1, :, None]], -1),
            self.axis)
        h, h_in = None, None
        for r in range(self.n):
            if r == self.rank:
                h_in = h
            st = got[r, ..., :-1].reshape(state.shape)
            h = st if h is None else (h * torch.exp(got[r, ..., -1])
                                      [..., None, None] + st)
        if h_in is None:                    # rank 0: nothing comes in
            if not got.requires_grad:
                return y, h
            h_in = got[:0].sum(0)[..., :-1].reshape(state.shape)
        part = torch.einsum("blhn,bhpn->blhp", Ch.to(f32)
                            * torch.exp(cum)[..., None], h_in)
        if head_mask is not None:
            part = part * head_mask.to(f32)[None, None, :, None]
        return y + part, h


def label_share(cfg, labels: torch.Tensor, seq: SeqSplit) -> torch.Tensor:
    """One data rank's share of a train step's loss on a sequence split:
    its block's labelled tokens over the whole batch's, ``labels`` (B, S)
    the whole batch's (a VLM's padded with -1 over its vision prefix
    first, as ``transformer.loss_fn`` cuts them); divided in float64 and
    rounded once to float32. The shares sum to 1."""
    f64 = torch.float64
    total = (labels >= 0).sum().to(f64)
    if cfg.vision_tokens:
        labels = F.pad(labels, (cfg.vision_tokens, 0), value=-1)
    mine = (seq.cut(labels, 1) >= 0).sum().to(f64)
    return (mine / total.clamp_min(1.0)).to(torch.float32)


def partial_softmax(logits: torch.Tensor, ok: torch.Tensor):
    """(p, m, l) of ``logits`` (..., K) over the slots where ``ok``: the
    max m over them (-inf where there is none), p = exp(logits - m) there
    and 0 elsewhere, l = sum(p): what ``SeqSplit.combine`` takes."""
    masked = logits.masked_fill(~ok, float("-inf"))
    m = masked.amax(-1)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(masked - safe[..., None])
    return p, m, p.sum(-1)


def sequential_shares(cfg, params, ranks, max_len: int):
    """(prefill shares, decode shares) of a sequence split over the data
    ranks of ``ranks`` (a ``tensor_parallel.SequentialRanks``: the shares
    run in one process one after another), "model" whole: each a
    ``TensorParallel`` of the whole tree ``params``. A prefill share's
    positions are split (``SeqSplit`` with ``tokens``) and its MoE
    dispatch is the whole batch's over the data ranks; a decode share
    reads the cache's ``max_len`` slots where they lie (one token on every
    rank)."""
    from repro_torch.sharding.tensor_parallel import (SequentialRanks,
                                                      TensorParallel)
    model = SequentialRanks(1).axes()[0]
    prefill = [TensorParallel.sliced(cfg, params, model, data=a,
                                     seq=SeqSplit(a, cfg=cfg,
                                                  max_len=max_len))
               for a in ranks.axes()]
    decode = [TensorParallel.sliced(cfg, params, model,
                                    seq=SeqSplit(a, tokens=False, cfg=cfg,
                                                 max_len=max_len))
              for a in ranks.axes()]
    return prefill, decode
