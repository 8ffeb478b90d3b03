"""Tensor parallelism over the "model" mesh axis for every stack of the
registry: GQA and MLA attention, the gated and non-gated FFN, the MoE
layer (experts over "model", the dispatch over the whole batch),
DeepSeek-V3's MTP head, Mamba2's SSD heads, Zamba2's shared block, and
the vocabulary.

The reference has no counterpart: it lays its arrays out by
``param_specs`` and GSPMD splits every product over "model". The port's
kernels take plain tensors, so each rank computes its own share on its
local tensors and the reductions between the shares are explicit:

* **Heads.** The q heads split into contiguous blocks, as even as they
  can be (``head_split``: 28 heads on 16 ranks are 2 each on 12 ranks and
  1 each on 4); a rank computes the KV heads its block reads (a KV head
  read by several ranks is computed on each). ``wq``, ``wk``, ``wv`` and
  their biases are taken by those columns, ``wo`` by those rows; the
  out product's partial sums are all-reduced over "model". Where a
  rank's block crosses KV groups unevenly, the flash kernel's ``h //
  group`` map does not hold, and each q head gets its KV head repeated
  (``TensorParallel.kv_for_q``); the kernel does not change.
* **MLA.** The latent projections (``w_dq``, ``w_dkv``, both norms) are
  computed whole on every rank; ``w_uq``, ``w_uk`` and ``w_uv`` are taken
  at the rank's heads, each by its own head width (192, 128 and 128
  columns at DeepSeek-V3), ``wo`` by rows of ``v_head_dim``.
* **FFN.** ``w_up`` and ``w_gate`` by columns (``ffn_mask`` sliced with
  them), ``w_down`` by rows, its partial sums all-reduced.
* **Experts** (``expert_split``). With at least as many experts as ranks,
  whole experts in contiguous blocks; with fewer, each expert on a
  contiguous group of ranks, its ``d_expert`` columns in blocks over the
  group. The shared experts split as the FFN does; the router is used
  whole, so every rank routes alike. Each rank dispatches only to its own
  experts; the combine's fp32 partial sums are all-reduced over "model".
* **SSD heads.** Mamba2's heads split into contiguous blocks as the q
  heads do (``head_split`` over the B/C groups: 80 heads on 16 ranks are
  5 each). A rank's block takes several ranges of ``w_in``'s columns (its
  heads' z and x, the B and C of the groups they read, its heads' dt), the
  conv's channels of its x, B and C, its heads' ``A_log``, ``dt_bias``,
  ``D`` and ``norm_scale`` columns, and ``w_out``'s rows; a group's B and
  C are computed on every rank whose heads read it. Where a block crosses
  groups unevenly each head gets its group's B and C repeated
  (``TensorParallel.ssd_groups``), as for KV heads. The gated norm's mean
  of squares spans the whole ``d_inner``: each rank's row sums are
  all-reduced (``kernels.rmsnorm.ops.split_gated_rmsnorm``).
* **Vocabulary.** Where the vocabulary divides "model" (as ``param_specs``
  shards ``embed`` and ``lm_head``): the embedding lookup gives zeros for
  ids outside a rank's rows, then an all-reduce; the logits stay split,
  gathered only where a step returns them; the loss is a vocabulary-
  parallel cross-entropy in fp32 (max and sum of exponentials all-reduced,
  the gold logit from the rank that holds it). Gemma's tied head is the
  same split. Elsewhere (HuBERT's 504 rows on 16) the head is replicated.
* **Gradients.** Megatron's pair of autograd Functions: identity forward
  and all-reduce backward at the input of a column product
  (``copy_to_model``), all-reduce forward and identity backward at the
  output of a row product (``reduce_from_model``).

Every "model" reduction goes through one seam, an *axis* with ``rank``,
``size``, ``all_reduce``, ``all_gather``, ``all_to_all`` and
``reduce_scatter``: ``GroupAxis`` over a process group (a mesh's "model"
group), or ``SequentialRanks``, which runs the shares of an n-rank split
in one process one after another, each reduction adding the shares in
rank order (the card's split checks, and tests). The data axes' exchanges
go through the same seam (``DataAxes`` on a mesh).

**The whole batch.** Where a mesh's data axes split the rows (or, on a
sequence split, the positions: ``sharding.context_parallel``), the MoE
dispatch and the losses that are not a mean of per-row terms are the whole
batch's, as the reference computes them on the global batch: the data
axes (``DataAxes``, "pod" major) carry an all-gather of each rank's expert
counts (capacity and each assignment's slot in global order), an
all-to-all of each kept row to the rank that computes its slot and of
its output back (``all_to_all_rows``: each row crosses once each way,
axis by axis over "pod" and "data"), and the sums of the
balance loss, the z-loss and the MTP loss (``batch_sum``: all-reduced
forward and backward, so that with each rank's loss weighted by its share
of the labels the gradient is the whole batch's).

Parameters reach a layer through ``TensorParallel.layer``: on a mesh
(``on_mesh``) one layer's slice of each stacked DTensor (or an unstacked
block's leaves: the MTP block), its data dims gathered (FSDP-style) and
its "model" shard kept where it is the rank's block, else gathered over
"model" and sliced; the gather's backward is the reduce-scatter of the
gradient (``Partial`` grad placements on the dims it gathered). The walk
is by path: an MoE layer's ``w_up`` is cut on its expert and column dims,
an FFN's on its columns. Whole trees (``sliced``) are sliced per rank with
no communication. A one-rank axis takes every shortcut: the unsharded
step's ops, the same bits.

The KV cache keeps ``cache_specs``' layout (``kv_cache_layout``): KV heads
over "model" where they divide, else the head dim, else replicated. Where
KV heads divide "model", every rank's shard is the KV heads its block reads
(``kv_local``) and nothing moves. Elsewhere the cache stays where it lies
and the queries come to it: the KV heads a rank computes reach the shards
by an all-to-all (the prefill's whole sequence, the decode step's new
slot); a decode step on a cache split on the head dim sends each rank's
queries at every rank's dims (an all-to-all), each rank scores every head
on its dims, the partial scores are all-reduced, and each rank's share of
the output goes back to the ranks whose heads they are (an all-to-all).
What moves a step is the queries, one layer's scores and the outputs,
never the cache; a replicated cache is read where it is. MLA's latent
cache is the same: ``ckv`` and ``krope`` each on their last dim where it
divides "model" (``latent_cache_layout``), else whole; its decode sends
the absorbed queries to the latent dims the same way.

Mamba2's cache keeps ``cache_specs``' layout too: the SSD state on its
heads where they divide "model" (every rank's shard its own heads, and
nothing moves), else whole, each rank writing its heads and the ranks'
blocks exchanged; the conv tail on its channels in contiguous blocks where
they divide "model", else whole. No rank's channels are a block, so the
data moves, never the cache: the prefill sends each rank's channels of
the tail to the shards that hold them (a group's B and C from the lowest
rank that computes them), and a decode step reads its channels' rows from
the shards and sends its new row to them (``Regather``: an all-to-all of
the pieces, its backward the reverse). A leaf split on a dim in several
ranges (``w_in``, ``conv_w``) reaches a rank the same way: its "model"
shard is kept and the ranges it wants come to it by an all-to-all.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: what a step's record says of the "model" axis
ROUTE_SPLIT = "split: heads, FFN columns, experts, SSD heads, vocabulary"


def _attends(cfg) -> bool:
    return cfg.attention in ("gqa", "mla") and bool(cfg.num_heads)


def tp_supported(cfg) -> bool:
    """Whether ``cfg``'s stack splits over "model": an attention stack
    (GQA or MLA attention and a dense FFN or an MoE layer in every layer,
    with or without an MTP head), a Mamba2 stack, or a hybrid of Mamba2
    layers and a shared GQA block. Every config of the registry is one."""
    if cfg.arch_type in ("dense", "audio", "vlm", "moe"):
        return _attends(cfg) and not cfg.shared_attn_period
    if cfg.arch_type == "ssm":
        return cfg.ssm is not None
    if cfg.arch_type == "hybrid":
        return cfg.ssm is not None and _attends(cfg)
    return False


def mesh_route(cfg) -> str:
    """The route a mesh step takes for ``cfg``: ``ROUTE_SPLIT``; a stack
    tensor parallelism does not cover is refused."""
    if not tp_supported(cfg):
        raise ValueError(f"{cfg.name}: no mesh route for arch "
                         f"{cfg.arch_type!r}")
    return ROUTE_SPLIT


def ffn_width(cfg) -> int:
    """The FFN's columns: ``d_ff``, or a hybrid's shared block's default
    (4 x d_model) where the config gives none."""
    if cfg.d_ff:
        return cfg.d_ff
    return 4 * cfg.d_model if cfg.shared_attn_period else 0


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
def blocks(n: int, m: int) -> List[Tuple[int, int]]:
    """``n`` units in ``m`` contiguous blocks as even as they can be, the
    first ``n % m`` one unit larger: [(lo, hi)] a rank."""
    q, rem = divmod(n, m)
    out, lo = [], 0
    for r in range(m):
        hi = lo + q + (r < rem)
        out.append((lo, hi))
        lo = hi
    return out


class HeadSplit(NamedTuple):
    q: Tuple[int, int]          # the rank's q heads [lo, hi)
    kv: Tuple[int, int]         # the KV heads they read [lo, hi)
    kv_of_q: Tuple[int, ...]    # each local q head's local KV head
    grouped: bool               # the kernel's h // group map holds


def head_split(num_heads: int, num_kv_heads: int, m: int) -> List[HeadSplit]:
    """Each "model" rank's q-head block (``blocks``) and the KV heads it
    reads, for any (heads, KV heads, model size); a rank with no q head
    (more ranks than heads) is refused."""
    if num_heads < m:
        raise ValueError(f"{num_heads} heads on {m} 'model' ranks: a rank "
                         f"would hold none")
    group = num_heads // num_kv_heads
    out = []
    for lo, hi in blocks(num_heads, m):
        k0, k1 = lo // group, (hi - 1) // group + 1
        kv_of_q = tuple(h // group - k0 for h in range(lo, hi))
        nq, nkv = hi - lo, k1 - k0
        grouped = nq % nkv == 0 and all(
            kv_of_q[h] == h // (nq // nkv) for h in range(nq))
        out.append(HeadSplit((lo, hi), (k0, k1), kv_of_q, grouped))
    return out


def kv_cache_layout(num_kv_heads: int, head_dim: int, m: int) -> str:
    """``cache_specs``' "model" rule for a KV cache: ``"heads"`` where the
    KV heads divide "model", else ``"dims"`` where the head dim does, else
    ``"whole"`` (replicated)."""
    if num_kv_heads % m == 0:
        return "heads"
    if head_dim % m == 0:
        return "dims"
    return "whole"


def kv_shard(num_kv_heads: int, head_dim: int, m: int,
             rank: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((heads lo, hi), (dims lo, hi)) of ``rank``'s KV cache shard."""
    layout = kv_cache_layout(num_kv_heads, head_dim, m)
    if layout == "heads":
        n = num_kv_heads // m
        return (rank * n, (rank + 1) * n), (0, head_dim)
    if layout == "dims":
        n = head_dim // m
        return (0, num_kv_heads), (rank * n, (rank + 1) * n)
    return (0, num_kv_heads), (0, head_dim)


class ExpertSplit(NamedTuple):
    experts: Tuple[int, int]    # the rank's experts [lo, hi)
    cols: Tuple[int, int]       # their d_expert columns [lo, hi)


def expert_split(num_experts: int, m: int,
                 d_expert: int) -> List[ExpertSplit]:
    """Each "model" rank's experts and their columns: with ``num_experts
    >= m`` whole experts in contiguous blocks (``blocks``, uneven
    allowed); with fewer, each expert on a contiguous group of ranks
    (``blocks(m, num_experts)``), its ``d_expert`` columns in blocks over
    the group (``w_up`` and ``w_gate`` take those columns, ``w_down``
    those rows)."""
    if num_experts >= m:
        return [ExpertSplit(b, (0, d_expert)) for b in blocks(num_experts, m)]
    out = []
    for e, (r0, r1) in enumerate(blocks(m, num_experts)):
        if d_expert < r1 - r0:
            raise ValueError(f"{d_expert} expert columns on {r1 - r0} "
                             f"ranks: a rank would hold none")
        out += [ExpertSplit((e, e + 1), c) for c in blocks(d_expert, r1 - r0)]
    return out


def latent_cache_layout(width: int, m: int) -> str:
    """``cache_specs``' "model" rule for an MLA cache leaf (``ckv``,
    ``krope``): ``"dims"`` where its last dim divides "model", else
    ``"whole"`` (replicated)."""
    return "dims" if width % m == 0 else "whole"


Ranges = Tuple[Tuple[int, int], ...]


def merged(ranges) -> Ranges:
    """``ranges`` in order with each range that starts where the one
    before ends joined to it, empty ones dropped."""
    out: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if hi <= lo:
            continue
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return tuple(out)


def ssm_ranges(cfg, split: HeadSplit) -> dict:
    """The ranges of each Mamba2 leaf a rank of SSD head block ``split``
    (``head_split`` over the B/C groups) uses, on the leaf's split dim, in
    the order the block reads them: ``w_in``'s columns (the heads' z and
    x, the groups' B and C, the heads' dt: the packed layout of the
    reference's ``_split_proj``), the conv's channels (x, B, C), the heads
    (``A_log``, ``dt_bias``, ``D``) and their ``d_inner`` columns
    (``norm_scale``, ``w_out``'s rows). Adjacent ranges are joined
    (``merged``): on one rank each leaf is one whole range."""
    s = cfg.ssm
    P, N = s.head_dim, s.d_state
    d_in, gn = cfg.d_inner, s.n_groups * s.d_state
    (h0, h1), (g0, g1) = split.q, split.kv
    x = (h0 * P, h1 * P)
    b = (g0 * N, g1 * N)
    return {
        "w_in": merged([x, (d_in + x[0], d_in + x[1]),
                        (2 * d_in + b[0], 2 * d_in + b[1]),
                        (2 * d_in + gn + b[0], 2 * d_in + gn + b[1]),
                        (2 * (d_in + gn) + h0, 2 * (d_in + gn) + h1)]),
        "conv": merged([x, (d_in + b[0], d_in + b[1]),
                        (d_in + gn + b[0], d_in + gn + b[1])]),
        "heads": ((h0, h1),),
        "inner": (x,)}


def block_shard(n: int, m: int, rank: int) -> Tuple[int, int]:
    """(lo, hi) of ``rank``'s shard of a dim of ``n`` split in ``m`` even
    blocks where ``m`` divides it (``cache_specs``' and ``param_specs``'
    rule: an MLA cache leaf's last dim, an SSD state's heads, a conv
    tail's channels), else the whole dim (replicated)."""
    if n % m:
        return 0, n
    return rank * (n // m), (rank + 1) * (n // m)


def _cut_of(dim: int, ranges: Ranges, ranged: bool = False):
    """One cut: ``(dim, ranges)``, the ranges joined in order on that dim,
    where ``ranged`` or there are several; else ``(dim, lo, hi)``. A leaf
    whose cut on some rank is several ranges takes the ranged form on
    every rank, so that every rank fetches it alike."""
    if ranged or len(ranges) > 1:
        return (dim, ranges)
    return (dim,) + ranges[0]


def _cut_ranges(cut) -> Ranges:
    return cut[1] if len(cut) == 2 else (cut[1:],)


class _Piece(NamedTuple):
    src: int          # the rank that sends it
    dst: int          # the rank that wants it
    src_off: int      # its offset in what ``src`` holds
    dst_off: int      # its offset in what ``dst`` wants
    n: int


class Regather:
    """Moving ranges of one dim between the ranks of an axis: rank r holds
    ``have[r]`` (ranges of the dim, concatenated in order) and wants
    ``want[r]``. Each unit a rank wants comes from itself where it holds
    it and ``prefer_self`` (a read), else from the lowest rank that holds
    it (a write: every copy of a unit several ranks computed is that one
    rank's). ``__call__`` is one all-to-all of the pieces over the axis,
    unless every piece stays on its rank; under autograd its backward
    sends each piece's gradient back and adds it where the piece came
    from."""

    def __init__(self, have: Sequence[Ranges], want: Sequence[Ranges],
                 prefer_self: bool = True):
        self.m = len(have)
        self.want_n = [sum(hi - lo for lo, hi in w) for w in want]
        self.have_n = [sum(hi - lo for lo, hi in h) for h in have]
        self.pieces: List[_Piece] = []
        for dst, ranges in enumerate(want):
            off = 0
            for lo, hi in ranges:
                for a, b, src, src_off in self._sources(have, lo, hi, dst,
                                                        prefer_self):
                    last = self.pieces[-1] if self.pieces else None
                    if (last is not None and last.dst == dst
                            and last.src == src
                            and last.src_off + last.n == src_off
                            and last.dst_off + last.n == off):
                        self.pieces[-1] = last._replace(n=last.n + b - a)
                    else:
                        self.pieces.append(_Piece(src, dst, src_off, off,
                                                  b - a))
                    off += b - a
        self.local = all(p.src == p.dst for p in self.pieces)
        self.identity = [self.local and list(have[r]) == list(want[r])
                         for r in range(self.m)]

    @staticmethod
    def _sources(have, lo, hi, dst, prefer_self):
        """[(a, b, src, src_off)]: [lo, hi) cut where its source changes."""
        cuts = {lo, hi}
        for ranges in have:
            for a, b in ranges:
                cuts.update(c for c in (a, b) if lo < c < hi)
        edges = sorted(cuts)
        out = []
        for a, b in zip(edges, edges[1:]):
            holders = [r for r, ranges in enumerate(have)
                       if any(x <= a and b <= y for x, y in ranges)]
            if not holders:
                raise ValueError(f"no rank holds [{a}, {b})")
            src = dst if prefer_self and dst in holders else holders[0]
            off = 0
            for x, y in have[src]:
                if x <= a and b <= y:
                    out.append((a, b, src, off + a - x))
                    break
                off += y - x
        return out

    def __call__(self, t: torch.Tensor, dim: int, axis) -> torch.Tensor:
        dim %= t.dim()
        if self.identity[axis.rank]:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _RegatherFn.apply(t, self, dim, axis)
        return self.forward(t, dim, axis)

    def _moved(self, t, dim, axis, out_of, into, off_from, off_to,
               total, tile: bool):
        """Each piece of ``t`` this rank sends (``out_of(me, r)``: to rank
        r, in order) sent, each it receives (``into(me, r)``: from rank
        r) placed at ``off_to`` in a tensor of ``total`` on ``dim``: their
        concatenation where they ``tile`` it, else their sum into zeros."""
        me = axis.rank

        def cat(parts):
            if not parts:
                shape = list(t.shape)
                shape[dim] = 0
                return t.new_zeros(shape)
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        sent = [cat([t.narrow(dim, off_from(p), p.n) for p in out_of(me, r)])
                for r in range(self.m)]
        if self.local:
            got = sent
        else:
            shapes = []
            for r in range(self.m):
                shape = list(t.shape)
                shape[dim] = sum(p.n for p in into(me, r))
                shapes.append(shape)
            got = axis.all_to_all(sent, shapes)
        placed = []
        for r in range(self.m):
            at = 0
            for p in into(me, r):
                placed.append((off_to(p), got[r].narrow(dim, at, p.n)))
                at += p.n
        placed.sort(key=lambda x: x[0])
        if tile:
            return cat([v for _, v in placed])
        shape = list(t.shape)
        shape[dim] = total
        out = t.new_zeros(shape)
        for o, v in placed:
            out.narrow(dim, o, v.shape[dim]).add_(v)
        return out

    def _pieces(self, src: int, dst: int) -> List[_Piece]:
        return [p for p in self.pieces if p.src == src and p.dst == dst]

    def forward(self, t, dim, axis):
        """The pieces this rank wants, in order (they tile its ranges)."""
        return self._moved(t, dim, axis, self._pieces,
                           lambda me, r: self._pieces(r, me),
                           lambda p: p.src_off, lambda p: p.dst_off,
                           self.want_n[axis.rank], tile=True)

    def backward(self, g, dim, axis):
        """The gradient of what this rank holds: each piece's gradient
        from the rank that wanted it, added where the piece came from
        (zero where no rank wanted it)."""
        return self._moved(g, dim, axis,
                           lambda me, r: self._pieces(r, me),
                           self._pieces,
                           lambda p: p.dst_off, lambda p: p.src_off,
                           self.have_n[axis.rank], tile=False)


class _RegatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan, dim, axis):
        ctx.plan, ctx.dim, ctx.axis = plan, dim, axis
        out = plan.forward(t, dim, axis)
        # a piece kept as a view of the input leaves the node as a copy
        base = t if t._base is None else t._base
        return out.clone() if out is t or out._base is base else out

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g, ctx.dim, ctx.axis), None, None, None


# ---------------------------------------------------------------------------
# the seam: every "model" reduction goes through an axis
# ---------------------------------------------------------------------------
class GroupAxis:
    """The "model" axis over a process group (a mesh's "model" group):
    eager ``c10d`` collectives, which ``roofline.analysis.TraceCounter``
    counts by op and mesh dim."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in rank order."""
        import torch.distributed as dist
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out.view((self.size,) + tuple(t.shape))

    def all_to_all(self, parts: Sequence[torch.Tensor],
                   shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """``parts[s]`` to rank ``s``; returns what each rank sent here, of
        ``shapes[r]`` from rank ``r``. This rank's own part stays local
        and is not sent."""
        import torch.distributed as dist
        me = self.rank
        send = [p.reshape(-1) if r != me else p.new_empty(0)
                for r, p in enumerate(parts)]
        sizes = [0 if r == me else math.prod(s) for r, s in enumerate(shapes)]
        inp = torch.cat(send)
        out = inp.new_empty(sum(sizes))
        dist.all_to_all_single(out, inp, sizes, [t.numel() for t in send],
                               group=self.group)
        return [parts[me] if r == me else o.view(tuple(s))
                for r, (o, s) in enumerate(zip(out.split(sizes), shapes))]

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...) summed over the ranks; this rank keeps
        entry ``rank`` of the sum."""
        import torch.distributed as dist
        out = t.new_empty(tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.reshape((-1,) + out.shape[1:]),
                                   group=self.group)
        return out


class DataAxes:
    """A mesh's data axes (``GroupAxis`` each, major first: "pod", then
    "data") as one axis of ``size`` ranks, ``rank`` in the order the rows
    are split (``launch.steps._my_rows``): each collective runs axis by
    axis."""

    def __init__(self, axes: Sequence[GroupAxis]):
        self.axes = list(axes)
        self.size, self.rank = 1, 0
        for a in self.axes:
            self.size *= a.size
            self.rank = self.rank * a.size + a.rank

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        for a in self.axes:
            t = a.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in rank order."""
        shape = tuple(t.shape)
        for a in reversed(self.axes):        # minor first
            t = a.all_gather(t)
        return t.reshape((self.size,) + shape)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...) summed over the ranks; entry ``rank`` of the
        sum."""
        blk = tuple(t.shape[1:])
        for a in self.axes:                  # major first
            t = a.reduce_scatter(t.reshape((a.size, -1) + blk))
        return t[0]

    def all_to_all_rows(self, x: torch.Tensor,
                        sizes: Sequence[Sequence[int]]) -> torch.Tensor:
        """``all_to_all_rows`` over these axes."""
        return all_to_all_rows(self.axes, x, sizes)


def all_to_all_rows(axes: Sequence, x: torch.Tensor,
                    sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """Ragged rows to ranks over data ``axes`` (major first, each with
    ``rank``, ``size`` and ``all_to_all``; ranks numbered as ``DataAxes``
    numbers them): ``x`` holds this rank's rows for rank 0, then rank 1,
    ...; ``sizes[r][q]`` is how many rows rank r sends rank q (every rank
    passes the same matrix). Returns the rows every rank sent here, in rank
    order. A rank's own rows stay local. Over several axes the rows move
    axis by axis, the minor one first (``_route``): a row crosses each axis
    where its source and its destination differ, once, and no other."""
    dims = tuple(a.size for a in axes)
    me = 0
    for a in axes:
        me = me * a.size + a.rank
    rest = tuple(x.shape[1:])
    # the non-empty (source, destination) blocks this rank holds, in order
    held = [(me, t) for t in range(len(sizes)) if sizes[me][t]]
    for j, sent, came in _route(dims, me):
        at, cuts = 0, {}
        for o, t in held:
            cuts[(o, t)] = (at, sizes[o][t])
            at += sizes[o][t]
        got = axes[j].all_to_all(
            [_rows(x, [cuts[b] for b in blks if b in cuts], rest)
             for blks in sent],
            [(sum(sizes[o][t] for o, t in blks),) + rest for blks in came])
        pieces = {}
        for part, blks in zip(got, came):
            at = 0
            for o, t in blks:
                if sizes[o][t]:
                    pieces[(o, t)] = part.narrow(0, at, sizes[o][t])
                    at += sizes[o][t]
        held = sorted(pieces)
        x = (torch.cat([pieces[b] for b in held]) if held
             else x.new_empty((0,) + rest))
    return x


@functools.lru_cache(maxsize=None)
def _route(dims: Tuple[int, ...], me: int):
    """``all_to_all_rows``' stages for rank ``me`` of a grid of ``dims``
    (major first): (axis, the (source, destination) blocks sent to each
    coordinate of the axis, those received from each), the minor axis
    first. Before the stage over an axis a rank holds the blocks whose
    source shares its coordinates on the axes not yet crossed and whose
    destination shares them on the axes crossed; it sends each block to
    the destination's coordinate on the axis. Every list is ordered by
    (source, destination)."""
    n = math.prod(dims)
    strides = [math.prod(dims[j + 1:]) for j in range(len(dims))]
    coord = [[g // s % m for s, m in zip(strides, dims)] for g in range(n)]
    crossed: set = set()

    def held_by(y: int):
        return [(o, t) for o in range(n) for t in range(n)
                if all((coord[t] if i in crossed else coord[o])[i]
                       == coord[y][i] for i in range(len(dims)))]
    stages = []
    for j in reversed(range(len(dims))):
        peers = [me + (c - coord[me][j]) * strides[j]
                 for c in range(dims[j])]
        mine = held_by(me)
        sent = [[b for b in mine if coord[b[1]][j] == c]
                for c in range(dims[j])]
        came = [[b for b in held_by(y) if coord[b[1]][j] == coord[me][j]]
                for y in peers]
        stages.append((j, sent, came))
        crossed.add(j)
    return tuple(stages)


def _rows(x: torch.Tensor, cuts, rest) -> torch.Tensor:
    """The rows ``cuts`` ((start, count), ...) of ``x`` one after
    another: a view where they are one range."""
    if len(cuts) == 1:
        return x.narrow(0, *cuts[0])
    if not cuts:
        return x.new_empty((0,) + rest)
    return torch.cat([x.narrow(0, *c) for c in cuts])


class SequentialRanks:
    """``size`` ranks of one process that take turns: ``run`` starts one
    thread a rank, and only the rank whose turn it is runs. At a
    reduction a rank leaves its share and passes the turn on; the last
    rank combines the shares in rank order (a sum adds rank 0's, then
    rank 1's, ...), and every rank reads that one result, which it must
    not modify in place. So rank 0's share runs to its first reduction,
    then rank 1's, and so on: the shares of an n-rank split one after
    another, on one device. A failure on any rank fails every rank."""

    def __init__(self, size: int):
        self.size = size
        self._cv = threading.Condition()
        self._turn = 0
        self._slots: List[Optional[torch.Tensor]] = [None] * size
        self._result = None
        self._failed: Optional[BaseException] = None

    def axes(self) -> List["_SequentialAxis"]:
        return [_SequentialAxis(self, r) for r in range(self.size)]

    def _wait(self, rank: int) -> None:
        self._cv.wait_for(lambda: self._turn == rank
                          or self._failed is not None)
        if self._failed is not None:
            raise RuntimeError(f"rank {rank}: another rank failed") \
                from self._failed

    def exchange(self, rank: int, t: torch.Tensor,
                 combine: Callable[[Sequence[torch.Tensor]], torch.Tensor]):
        with self._cv:
            self._slots[rank] = t
            if rank == self.size - 1:
                self._result = combine(self._slots)
                self._slots = [None] * self.size
            self._turn = (rank + 1) % self.size
            self._cv.notify_all()
            self._wait(rank)
            return self._result

    def run(self, fns: Sequence[Callable[[], object]]) -> list:
        """Each rank's ``fns[r]()`` in turn; their results in rank order.
        The caller's grad mode holds in every rank's thread."""
        if len(fns) != self.size:
            raise ValueError(f"{len(fns)} functions for {self.size} ranks")
        grad = torch.is_grad_enabled()
        results: list = [None] * self.size

        def body(r):
            try:
                with self._cv:
                    self._wait(r)
                with torch.set_grad_enabled(grad):
                    results[r] = fns[r]()
                with self._cv:
                    self._turn = (r + 1) % self.size
                    self._cv.notify_all()
            except BaseException as e:              # noqa: BLE001
                with self._cv:
                    if self._failed is None:
                        self._failed = e
                    self._cv.notify_all()
        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._failed is not None:
            raise self._failed
        return results


class _SequentialAxis:
    """One rank of ``SequentialRanks``. A reduction's or gather's result
    is one tensor that every rank reads; each rank gets its own view of
    it, so that an autograd Function's output (``_SumBatch``,
    ``_GatherSlots``) joins that rank's graph alone."""

    def __init__(self, ranks: SequentialRanks, rank: int):
        self.ranks, self.rank, self.size = ranks, rank, ranks.size

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        def combine(ts):
            out = ts[0]
            for s in ts[1:]:
                out = torch.maximum(out, s) if op == "max" else out + s
            return out
        out = self.ranks.exchange(self.rank, t, combine)
        return out.view(out.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = self.ranks.exchange(self.rank, t, torch.stack)
        return out.view(out.shape)

    def all_to_all(self, parts, shapes) -> List[torch.Tensor]:
        """``GroupAxis.all_to_all``'s: parts of any sizes, empty ones
        too; each part checked against the shape its receiver expects."""
        sent = self.ranks.exchange(self.rank, list(parts), list)
        got = [sent[r][self.rank] for r in range(self.size)]
        for r, (t, shape) in enumerate(zip(got, shapes)):
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"rank {self.rank} expected {tuple(shape)} "
                                 f"from rank {r}, got {tuple(t.shape)}")
        return got

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...) summed over the ranks in rank order; entry
        ``rank`` of the sum."""
        return self.all_reduce(t)[self.rank]


# ---------------------------------------------------------------------------
# the two autograd Functions
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """The input of a column product: identity forward, the gradient
    all-reduced over "model" backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    """The output of a row product: partial sums all-reduced over "model"
    forward, the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModel.apply(x, axis)


class _SumBatch(torch.autograd.Function):
    """A sum over the data axes of a loss's per-rank part: all-reduced
    forward, and the gradient all-reduced backward. Every rank then holds
    the whole batch's value; where each rank's loss is weighted by its
    share of the labels (the shares summing to 1), the backward's sum
    gives each rank's part the whole batch's gradient, not its share of
    it."""

    @staticmethod
    def forward(ctx, x, data):
        ctx.data = data
        return data.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.data.all_reduce(g), None


class _SendRows(torch.autograd.Function):
    """Ragged rows to ranks over the data axes (``all_to_all_rows``); the
    backward sends each row's gradient back to the rank it came from (the
    reverse all-to-all, the sizes transposed)."""

    @staticmethod
    def forward(ctx, x, data, sizes):
        ctx.data, ctx.sizes = data, sizes
        return all_to_all_rows(_axes_of(data), x, sizes)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(_axes_of(ctx.data), g.contiguous(),
                               transposed(ctx.sizes)), None, None


def _axes_of(data) -> list:
    """The axes of a data seam: a ``DataAxes``' own, else the one axis."""
    return data.axes if isinstance(data, DataAxes) else [data]


def transposed(sizes: Sequence[Sequence[int]]) -> List[List[int]]:
    """``sizes[r][q]`` as ``out[q][r]``: the return trip's sizes."""
    return [list(col) for col in zip(*sizes)]


class _GatherSlots(torch.autograd.Function):
    """(...) -> (size, ...) of every data rank's (all-gather); the
    backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, data):
        ctx.data = data
        return data.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.data.reduce_scatter(g), None


def all_gather_grad(t: torch.Tensor, axis) -> torch.Tensor:
    """(axis.size, *t.shape): every rank's ``t`` in rank order (an
    all-gather); the backward reduce-scatters the gradient, each rank's
    part back to the rank whose ``t`` it was (``_GatherSlots``)."""
    return _GatherSlots.apply(t, axis)


def data_axes(mesh, stage: bool = False) -> "DataAxes":
    """The mesh's data groups, every dim but "model" of more than one
    rank ("pod" too, unless ``stage``: a pod pipeline's), as one
    ``DataAxes``."""
    names = mesh.mesh_dim_names
    return DataAxes([GroupAxis(mesh.get_group(j), mesh.get_local_rank(j),
                               mesh.size(j))
                     for j, n in enumerate(names)
                     if n != "model" and mesh.size(j) > 1
                     and not (stage and n == "pod")])


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------
def vocab_embedding(table: torch.Tensor, ids: torch.Tensor, lo: int,
                    axis) -> torch.Tensor:
    """Rows ``ids`` of the embedding whose rows [lo, lo + len(table)) this
    rank holds: zeros for ids outside them, summed over "model" (exact:
    one rank holds each id)."""
    local = ids - lo
    ok = (local >= 0) & (local < table.shape[0])
    e = table[local.clamp(0, table.shape[0] - 1)]
    return reduce_from_model(e.masked_fill(~ok[..., None], 0), axis)


def vocab_xent(logits: torch.Tensor, labels: torch.Tensor, lo: int,
               axis, parts: bool = False):
    """``softmax_xent`` of logits split over "model" (this rank's columns
    [lo, lo + logits.shape[-1])), in fp32: the row max and the sum of
    exponentials all-reduced, the gold logit from the rank holding it;
    labels < 0 masked out, the sum over max(count, 1) (with ``parts``,
    the sum and the count)."""
    logits = logits.to(torch.float32)
    mask = labels >= 0
    big = axis.all_reduce(logits.detach().amax(-1), op="max")
    s = reduce_from_model(torch.exp(logits - big[..., None]).sum(-1), axis)
    local = labels - lo
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1,
                        local.clamp(0, logits.shape[-1] - 1)[..., None])
    gold = reduce_from_model(gold[..., 0].masked_fill(~mine, 0.0), axis)
    nll = (torch.log(s) + big - gold) * mask
    if parts:
        return nll.sum(), mask.sum()
    return nll.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# a rank's plan and its parameters
# ---------------------------------------------------------------------------
class TensorParallel:
    """One rank's share of a stack: its head block (``heads``, None
    without attention), FFN columns (``ffn``), experts and their columns
    (``experts``), shared expert columns (``shared``), SSD head block
    (``ssd``: a ``HeadSplit`` over the B/C groups, None without Mamba2
    layers), vocabulary rows (``vocab``, None where the head is
    replicated) and KV, latent or SSM cache shard, the "model" axis its
    reductions go through, the data axes (``data``: a ``DataAxes``, None
    where they do not split the rows) its whole-batch sums go through, the
    sequence split over the data axes (``seq``: a
    ``context_parallel.SeqSplit``, None where the positions and the cache's
    slots are whole), and ``fetch``, which hands it parameters:
    ``fetch(tp, path, tensor, layer)`` with ``tp.cuts(path)``."""

    def __init__(self, cfg, axis, fetch, data=None, seq=None):
        if not tp_supported(cfg):
            raise ValueError(f"{cfg.name}: tensor parallelism has no split "
                             f"of arch {cfg.arch_type!r}")
        self.cfg, self.axis, self._fetch = cfg, axis, fetch
        self.data = data if data is not None and data.size > 1 else None
        self.seq = seq if seq is not None and seq.n > 1 else None
        m, r = axis.size, axis.rank
        self.heads = self.ffn = self.ssd = None
        if _attends(cfg):
            self._init_attention(cfg, m, r)
        if ffn_width(cfg):
            self.ffn = blocks(ffn_width(cfg), m)[r]
        moe = cfg.moe
        self.experts = (expert_split(moe.num_experts, m, moe.d_expert)[r]
                        if moe is not None else None)
        self.shared = (blocks(moe.d_expert * moe.num_shared, m)[r]
                       if moe is not None and moe.num_shared else None)
        V = cfg.padded_vocab
        self.vocab = ((r * V // m, (r + 1) * V // m)
                      if m > 1 and V % m == 0 else None)
        if cfg.ssm is not None:
            self._init_ssm(cfg, m, r)
        self._params = None

    def _init_attention(self, cfg, m: int, r: int) -> None:
        self._heads_all = head_split(cfg.num_heads, cfg.num_kv_heads, m)
        self.heads = self._heads_all[r]
        self.kv_heads, self.kv_dims = kv_shard(cfg.num_kv_heads,
                                               cfg.head_dim, m, r)
        self.kv_layout = kv_cache_layout(cfg.num_kv_heads, cfg.head_dim, m)
        # the cache is read and written where it lies when every rank's
        # shard is the KV heads it computes (the ranks make the same
        # collective calls); that holds wherever the KV heads divide
        # "model", since they divide the q heads too
        self.kv_local = all(
            kv_shard(cfg.num_kv_heads, cfg.head_dim, m, i)
            == (s.kv, (0, cfg.head_dim))
            for i, s in enumerate(self._heads_all))
        # the KV heads each rank sends to the shards: those it computes
        # that no lower rank computes (contiguous, ascending by rank)
        self._owned, seen = [], 0
        for s in self._heads_all:
            lo = max(s.kv[0], seen)
            self._owned.append((lo, max(lo, s.kv[1])))
            seen = max(seen, s.kv[1])
        if cfg.attention == "mla":
            widths = (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)
            self.latent_layouts = tuple(latent_cache_layout(w, m)
                                        for w in widths)
            self.latent_dims = tuple(block_shard(w, m, r) for w in widths)

    def _init_ssm(self, cfg, m: int, r: int) -> None:
        """The SSD head blocks, each rank's leaf ranges (``ssm_ranges``),
        the SSM cache's shards (``block_shard``: the state's heads, the
        conv tail's channels) and the moves between them (``Regather``)."""
        s = cfg.ssm
        H, cdim = cfg.ssm_heads, cfg.d_inner + 2 * s.n_groups * s.d_state
        self._ssd_all = head_split(H, s.n_groups, m)
        self.ssd = self._ssd_all[r]
        self._ssm_ranges = [ssm_ranges(cfg, sp) for sp in self._ssd_all]
        self.state_heads = block_shard(H, m, r)
        self.conv_dims = block_shard(cdim, m, r)
        self.state_layout = "heads" if H % m == 0 else "whole"
        self.conv_layout = "dims" if cdim % m == 0 else "whole"
        chans = [rg["conv"] for rg in self._ssm_ranges]
        shards = [(block_shard(cdim, m, i),) for i in range(m)]
        heads = [sp.q for sp in self._ssd_all]
        states = [(block_shard(H, m, i),) for i in range(m)]
        self._conv_out = Regather(chans, shards, prefer_self=False)
        self._conv_in = Regather(shards, chans)
        self._state_out = Regather([(h,) for h in heads], states,
                                   prefer_self=False)
        self._state_in = Regather(states, [(h,) for h in heads])
        self._fetches = {}

    # -- construction ---------------------------------------------------------
    @classmethod
    def sliced(cls, cfg, params, axis, data=None,
               seq=None) -> "TensorParallel":
        """The share of rank ``axis.rank`` of a whole (plain) parameter
        tree: each leaf sliced to the rank's block, no communication;
        ``data`` and ``seq`` as the constructor's."""
        tp = cls(cfg, axis, _slice_leaf, data, seq)
        tp._params = params
        return tp

    @classmethod
    def on_mesh(cls, cfg, mesh, params, split: str = "whole",
                stage: bool = False,
                max_len: Optional[int] = None) -> "TensorParallel":
        """This rank's share on ``mesh`` of a DTensor tree laid out by
        ``param_specs``: its "model" axis is the mesh's "model" group. How
        the step lies over the mesh's data groups (``split``, a
        ``context_parallel.data_split`` word or ``"slots"``): ``"rows"``,
        its rows split over them (``data``: the whole-batch sums go
        through them); ``"sequence"``, its positions split over them
        (``data``, and ``seq`` with ``tokens``); ``"slots"``, a decode
        step whose cache's slots may lie over them (``seq`` without
        ``tokens``, its layout made from the cache's ``max_len``, the
        slots before a window, as the prefill's; no ``data``: every
        rank holds the step's tokens); ``"whole"``, none (every data rank
        holds the same rows and computes them alike). With ``stage`` the
        tree is a pod pipeline's
        (``core.partition.pod_pipeline.stage_param_specs``): ``runs[0]``'s
        leaves are (n_pods, L/P, ...) with the stage dim over "pod", a
        layer is one of this rank's pod's own (``_MeshFetch``), and "pod"
        is no data axis."""
        from repro_torch.sharding.context_parallel import SeqSplit
        names = mesh.mesh_dim_names
        i = names.index("model")
        axis = GroupAxis(mesh.get_group(i), mesh.get_local_rank(i),
                         mesh.size(i))
        data = seq = None
        if split != "whole":
            data = data_axes(mesh, stage)
        if split in ("sequence", "slots"):
            seq = SeqSplit(data, tokens=split == "sequence", cfg=cfg,
                           max_len=max_len)
        tp = cls(cfg, axis, _MeshFetch(mesh, stage),
                 None if split == "slots" else data, seq)
        tp._params = params
        return tp

    @property
    def seq_tokens(self):
        """``seq`` where it splits the step's positions (a prefill's or a
        pod stage's), else None."""
        return self.seq if self.seq is not None and self.seq.tokens else None

    def for_config(self, cfg) -> "TensorParallel":
        """The same rank's share of the same tree, split as ``cfg`` is (the
        MTP block, a GQA block of the MTP config)."""
        tp = TensorParallel(cfg, self.axis, self._fetch, self.data,
                            self.seq)
        tp._params = self._params
        return tp

    # -- ranges and parameters ------------------------------------------------
    def cuts(self, path) -> Tuple[Tuple[int, int, int], ...]:
        """((dim, lo, hi), ...): this rank's block of one layer's leaf at
        ``path`` (keys from the layer: ``("attn", "wq")``, ``("moe",
        "w_up")``), of ``("embed",)`` or ``("lm_head",)``; empty for a leaf
        the rank uses whole. Dims are those of one layer's leaf."""
        name = path[-1]
        scope = path[-2] if len(path) > 1 else ""
        if scope == "attn":
            return self._attn_cuts(name)
        if scope == "mlp":
            dim = {"w_up": -1, "w_gate": -1, "w_down": 0}.get(name)
            return () if dim is None else ((dim,) + self.ffn,)
        if scope == "moe":
            return self._expert_cuts(name)
        if scope == "ssm":
            return self._ssm_cuts(name, self.axis.rank)
        if scope == "" and name in ("embed", "lm_head") and self.vocab:
            return (({"embed": 0, "lm_head": -1}[name],) + self.vocab,)
        return ()

    def _attn_cuts(self, name):
        (q0, q1), (k0, k1) = self.heads.q, self.heads.kv
        if self.cfg.attention == "mla":
            m = self.cfg.mla
            width = {"w_uq": m.qk_nope_head_dim + m.qk_rope_head_dim,
                     "w_uk": m.qk_nope_head_dim, "w_uv": m.v_head_dim,
                     "wo": m.v_head_dim}.get(name)
            if width is None:          # the latent projections and norms
                return ()
            return ((0 if name == "wo" else -1, q0 * width, q1 * width),)
        D = self.cfg.head_dim
        if name in ("wq", "bq", "wo"):
            return ((0 if name == "wo" else -1, q0 * D, q1 * D),)
        if name in ("wk", "bk", "wv", "bv"):
            return ((-1, k0 * D, k1 * D),)
        return ()

    def _ssm_cuts(self, name, rank: int):
        """A Mamba2 leaf's cut for ``rank``'s SSD head block: ``w_in`` on
        its columns, ``conv_w`` and ``conv_b`` on their channels (each in
        several ranges where the rank holds more than one head and
        another's groups), the per-head leaves on their heads,
        ``norm_scale`` on its ``d_inner`` columns, ``w_out`` on its
        rows."""
        key, dim = {"w_in": ("w_in", -1), "conv_w": ("conv", -1),
                    "conv_b": ("conv", -1), "A_log": ("heads", -1),
                    "dt_bias": ("heads", -1), "D": ("heads", -1),
                    "norm_scale": ("inner", -1),
                    "w_out": ("inner", 0)}[name]
        return (_cut_of(dim, self._ssm_ranges[rank][key],
                        ranged=key in ("w_in", "conv")),)

    def gather_ranges(self, t: torch.Tensor, path, shard: int
                      ) -> torch.Tensor:
        """``t``, this rank's contiguous block of ``shard`` entries on the
        dim a leaf at ``path`` is cut on in several ranges (its "model"
        shard), as the ranges this rank's cut names: each range from the
        rank whose block holds it, by an all-to-all (``Regather``); the
        backward sends each range's gradient back to its block."""
        dim = self.cuts(path)[0][0]
        key = (path[-1], shard)
        plan = self._fetches.get(key)
        if plan is None:
            m = self.axis.size
            plan = self._fetches[key] = Regather(
                [((i * shard, (i + 1) * shard),) for i in range(m)],
                [_cut_ranges(self._ssm_cuts(path[-1], i)[0])
                 for i in range(m)])
        return plan(t, dim, self.axis)

    def _expert_cuts(self, name):
        if name in ("w_up_sh", "w_gate_sh"):
            return ((-1,) + self.shared,)
        if name == "w_down_sh":
            return ((0,) + self.shared,)
        if name not in ("w_up", "w_gate", "w_down"):
            return ()                          # the router: whole
        moe = self.cfg.moe
        (e0, e1), (c0, c1) = self.experts
        out = []
        if (e0, e1) != (0, moe.num_experts):
            out.append((0, e0, e1))
        if (c0, c1) != (0, moe.d_expert):
            out.append((1 if name == "w_down" else 2, c0, c1))
        return tuple(out)

    def _walk(self, tree, path, layer):
        return {k: self._walk(v, path + (k,), layer) if isinstance(v, dict)
                else self._fetch(self, path + (k,), v, layer)
                for k, v in tree.items()}

    def layer(self, *where):
        """Layer ``j`` of run ``run`` (``layer(run, j)``), or the unstacked
        block at a key path of the tree (``layer("mtp", "block")``): every
        leaf this rank's block of it."""
        if isinstance(where[0], int):
            run, j = where
            return self._walk(self._params["runs"][run], (), j)
        tree = self._params
        for k in where:
            tree = tree[k]
        return self._walk(tree, (), None)

    def top(self, *path) -> torch.Tensor:
        """A leaf outside the runs (``top("embed")``, ``top("mtp",
        "proj")``)."""
        t = self._params
        for k in path:
            t = t[k]
        return self._fetch(self, path, t, None)

    def mask(self, mask):
        """A layer's masks sliced to this rank's heads and FFN columns (the
        expert mask stays whole: the router is)."""
        if not mask:
            return mask
        out = dict(mask)
        if out.get("head_mask") is not None:
            out["head_mask"] = out["head_mask"][slice(*self.heads.q)]
        if out.get("ffn_mask") is not None:
            out["ffn_mask"] = out["ffn_mask"][slice(*self.ffn)]
        if out.get("ssm_head_mask") is not None:
            out["ssm_head_mask"] = out["ssm_head_mask"][slice(*self.ssd.q)]
        return out

    # -- the layers' reductions -----------------------------------------------
    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.axis)

    def kv_for_q(self, k: torch.Tensor, v: torch.Tensor):
        """K and V (B, S, local KV heads, D) for the kernel: as they are
        where each local q head h reads KV head h // group, else repeated
        to one KV head a q head (group 1)."""
        if self.heads.grouped:
            return k, v
        idx = torch.tensor(self.heads.kv_of_q, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)

    # -- Mamba2 -------------------------------------------------------------
    def ssd_groups(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """B or C of the groups this rank's SSD heads read (on ``dim``) as
        the scan takes them: as they are where each local head h reads
        group h // (heads / groups), else one group a head, repeated (the
        ``ssd_scan`` wrapper takes groups that divide the heads)."""
        if self.ssd.grouped:
            return t
        idx = torch.tensor(self.ssd.kv_of_q, device=t.device)
        return t.index_select(dim, idx)

    def store_conv(self, tail: torch.Tensor) -> torch.Tensor:
        """The conv tail of this rank's channels (..., K-1, channels) as
        its cache shard (..., K-1, shard channels): each channel from the
        lowest rank that computes it."""
        return self._conv_out(tail, -1, self.axis)

    def read_conv(self, shard: torch.Tensor) -> torch.Tensor:
        """This rank's channels of the conv tail, read from the shards."""
        return self._conv_in(shard, -1, self.axis)

    def write_conv(self, shard: torch.Tensor, row: torch.Tensor
                   ) -> torch.Tensor:
        """The shard after a decode step: its rows moved up one, the new
        row (..., 1, this rank's channels) of its channels last."""
        return torch.cat([shard[..., 1:, :], self.store_conv(row)], dim=-2)

    def store_state(self, state: torch.Tensor) -> torch.Tensor:
        """The SSD state of this rank's heads (B, heads, P, N) as its cache
        shard: as it is where the state splits on the heads, else every
        rank's heads gathered."""
        return self._state_out(state, 1, self.axis)

    def read_state(self, shard: torch.Tensor) -> torch.Tensor:
        """This rank's heads of its state shard (no communication)."""
        return self._state_in(shard, 1, self.axis)

    # -- the whole batch ------------------------------------------------------
    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axes (forward and backward: see
        ``_SumBatch``); as it is where they do not split the rows."""
        return t if self.data is None else _SumBatch.apply(t, self.data)

    def batch_count(self, t: torch.Tensor) -> torch.Tensor:
        """An integer count summed over the data axes (no gradient)."""
        return t if self.data is None else self.data.all_reduce(t)

    def send_rows(self, x: torch.Tensor,
                  sizes: Sequence[Sequence[int]]) -> torch.Tensor:
        """Rows to the data ranks (``all_to_all_rows``: ``x`` this rank's
        rows for each rank in turn, ``sizes[r][q]`` the rows rank r sends
        rank q), the rows each rank sent here in rank order; the gradient
        goes back the same way (``_SendRows``)."""
        return _SendRows.apply(x, self.data, sizes)

    # -- the vocabulary -------------------------------------------------------
    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.top("embed")
        if self.vocab is None:
            return table[ids]
        return vocab_embedding(table, ids, self.vocab[0], self.axis)

    def head(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.top("embed").T
        return self.top("lm_head")

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x @ the head: this rank's vocabulary columns where it is split,
        all of them where it is replicated."""
        if self.vocab is not None:
            x = self.copy_in(x)
        return x @ self.head()

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits split over "model" gathered to the whole vocabulary."""
        if self.vocab is None:
            return logits
        return torch.cat(self.axis.all_gather(logits).unbind(0), dim=-1)

    # -- the KV cache ---------------------------------------------------------
    def _shard(self, rank: int):
        return kv_shard(self.cfg.num_kv_heads, self.cfg.head_dim,
                        self.axis.size, rank)

    def _to_shard(self, t: torch.Tensor, hdim: int) -> torch.Tensor:
        """``t`` (..., this rank's KV heads on ``hdim``, ..., D) as this
        rank's cache shard: an all-to-all in which each rank sends every
        shard the KV heads it owns (``_owned``) at that shard's dims."""
        k0 = self.heads.kv[0]
        o0, o1 = self._owned[self.axis.rank]
        (m0, m1), (e0, e1) = self._shard(self.axis.rank)
        parts, shapes = [], []
        for r in range(self.axis.size):
            (h0, h1), (d0, d1) = self._shard(r)
            lo, hi = max(o0, h0), min(o1, h1)
            parts.append(t.narrow(hdim, lo - k0 if hi > lo else 0,
                                  max(hi - lo, 0))[..., d0:d1])
            a0, a1 = self._owned[r]
            shape = list(t.shape)
            shape[hdim] = max(min(a1, m1) - max(a0, m0), 0)
            shape[-1] = e1 - e0
            shapes.append(shape)
        return torch.cat(self.axis.all_to_all(parts, shapes), dim=hdim)

    def store_kv(self, k: torch.Tensor, v: torch.Tensor):
        """The prefill's (k, v) (B, S, this rank's KV heads, D) as this
        rank's cache shard (B, S, shard heads, shard dims)."""
        if self.kv_local:
            return k, v
        kv = self._to_shard(torch.stack([k, v]), 3)
        return kv[0], kv[1]

    def decode_attention(self, q: torch.Tensor, cache, k: torch.Tensor,
                         v: torch.Tensor, slot: torch.Tensor, valid, pos,
                         window, scale: float) -> torch.Tensor:
        """Write the step's new key and value (B, this rank's KV heads, D)
        at ``slot`` into this rank's shard (``cache``, a ``KVCache`` of one
        layer: (B, Smax, shard heads, shard dims)), in place, and return
        ``decode_attention`` of this rank's q heads (B, 1, heads, D). A
        cache split on the head dim is not moved: the queries go to it
        (module docstring). Where ``seq`` splits the cache's slots
        (``seq.kv``) over the data axes, ``slot``, ``valid`` and the window
        are in those global slots, the shard is this rank's block of them,
        only the slot's owner writes it, and the ranks' partial softmaxes
        are combined (``context_parallel.SeqSplit.combine``)."""
        from repro_torch.models.layers.attention import decode_attention
        rows = torch.arange(k.shape[0], device=k.device)
        if not self.kv_local:
            k, v = self._to_shard(torch.stack([k, v]), 2).unbind(0)
        extra = {}
        lay = None if self.seq is None else self.seq.kv
        if lay is not None and lay.split:
            self.seq.owner_write(cache.k, slot, k, lay)
            self.seq.owner_write(cache.v, slot, v, lay)
            extra = dict(k_offset=lay.lo,
                         combine=self.seq.combine)
        else:
            cache.k[rows, slot] = k
            cache.v[rows, slot] = v
        if self.kv_layout == "dims" and not self.kv_local:
            return self._dims_attention(q, cache, valid, pos, window, scale,
                                        **extra)
        k0, k1 = self.heads.kv
        kc, vc = (c if self.kv_local else c.narrow(2, k0, k1 - k0)
                  for c in (cache.k, cache.v))
        return decode_attention(q, *self.kv_for_q(kc, vc), valid, pos,
                                window, scale, **extra)

    def _dims_attention(self, q, cache, valid, pos, window, scale,
                        **extra):
        """Decode attention on a cache split on the head dim: every q head
        at this rank's dims (an all-to-all of the queries), its partial
        scores summed over "model" inside ``decode_attention``, then each
        rank's heads at every rank's dims (an all-to-all of the output)."""
        from repro_torch.models.layers.attention import decode_attention
        B, _, nq, _ = q.shape
        qb = [s.q for s in self._heads_all]
        dims = [self._shard(r)[1] for r in range(self.axis.size)]
        e0, e1 = self.kv_dims
        qa = torch.cat(self.axis.all_to_all(
            [q[..., a:b] for a, b in dims],
            [(B, 1, hi - lo, e1 - e0) for lo, hi in qb]), dim=2)
        out = decode_attention(qa, cache.k, cache.v, valid, pos, window,
                               scale, partial_sum=self.axis.all_reduce,
                               **extra)
        return torch.cat(self.axis.all_to_all(
            [out[:, :, lo:hi] for lo, hi in qb],
            [(B, 1, nq, b - a) for a, b in dims]), dim=-1)

    # -- MLA's latent cache ---------------------------------------------------
    def store_latent(self, ckv: torch.Tensor, krope: torch.Tensor):
        """The whole latent and rotary key (..., width) as this rank's
        cache shard: its slice of each leaf's last dim (no
        communication: every rank holds them whole)."""
        (a0, a1), (b0, b1) = self.latent_dims
        return ckv[..., a0:a1], krope[..., b0:b1]

    def _latent_reads(self, leaf: int):
        """The dims of latent leaf ``leaf`` (0: ``ckv``, 1: ``krope``) each
        rank scores: its shard where the leaf is split; where it is whole,
        all of them on rank 0 and none elsewhere (its partial scores are
        then summed once)."""
        m = self.axis.size
        width = (self.cfg.mla.kv_lora_rank,
                 self.cfg.mla.qk_rope_head_dim)[leaf]
        if self.latent_layouts[leaf] == "dims":
            return [block_shard(width, m, r) for r in range(m)]
        return [(0, width)] + [(0, 0)] * (m - 1)

    def latent_attention(self, q_lat: torch.Tensor, q_rope: torch.Tensor,
                         cache, pos, scale: float) -> torch.Tensor:
        """``mla_decode``'s scores, softmax and latent output, in fp32,
        of this rank's heads (``q_lat`` (B, heads, kv_lora_rank) and
        ``q_rope`` (B, heads, rope dim), float32) against this rank's shard
        of the latent cache (``cache``: an ``MLACache`` of one layer, the
        step's slot already written): o_lat (B, heads, kv_lora_rank)
        float32. Where a leaf is split the queries go to it (module
        docstring): every head's absorbed queries at this rank's dims (an
        all-to-all), the partial scores all-reduced, the softmax on every
        rank, the latent output at this rank's dims sent back to the ranks
        whose heads they are (an all-to-all). Where both leaves are whole
        each rank reads its own heads' scores where the cache lies. Where
        ``seq`` splits the latent slots (``seq.latent``) over the data
        axes, the softmax is each rank's block's part, combined over
        them."""
        from repro_torch.models.layers.attention import (latent_attention,
                                                         latent_scores)
        seq = (self.seq if self.seq is not None and self.seq.latent.split
               else None)
        if self.latent_layouts == ("whole", "whole"):
            return latent_attention(q_lat, q_rope, cache, pos, scale, seq)
        B, nq = q_lat.shape[:2]
        qb = [s.q for s in self._heads_all]
        reads = [self._latent_reads(0), self._latent_reads(1)]
        me = self.axis.rank
        local = [c if lay == "dims" else c[..., slice(*rd[me])]
                 for c, lay, rd in zip((cache.ckv, cache.krope),
                                       self.latent_layouts, reads)]
        qs = [torch.cat(self.axis.all_to_all(
            [q[..., a:b] for a, b in rd],
            [(B, hi - lo, rd[me][1] - rd[me][0]) for lo, hi in qb]), dim=1)
            for q, rd in zip((q_lat, q_rope), reads)]
        if seq is None:
            probs = latent_scores(qs[0], qs[1], local[0], local[1], pos,
                                  scale, partial_sum=self.axis.all_reduce)
            o = torch.einsum("bhk,bkr->bhr", probs,
                             local[0].to(torch.float32))
        else:
            p, mx, lsum = latent_scores(
                qs[0], qs[1], local[0], local[1], pos, scale,
                partial_sum=self.axis.all_reduce,
                k_offset=seq.latent.lo)
            o = seq.combine(mx, lsum, torch.einsum(
                "bhk,bkr->bhr", p, local[0].to(torch.float32)))
        return torch.cat(self.axis.all_to_all(
            [o[:, lo:hi] for lo, hi in qb],
            [(B, nq, b - a) for a, b in reads[0]]), dim=-1)


def _narrow(t: torch.Tensor, cuts) -> torch.Tensor:
    """``t`` cut by each of ``cuts`` (``(dim, lo, hi)``, or ``(dim,
    ranges)``: the ranges joined in order on that dim)."""
    for cut in cuts:
        dim = cut[0] % t.dim()
        ranges = _cut_ranges(cut)
        if len(ranges) > 1:
            t = torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges],
                          dim)
        elif ranges[0] != (0, t.shape[dim]):
            t = t.narrow(dim, ranges[0][0], ranges[0][1] - ranges[0][0])
    return t


def _slice_leaf(tp: TensorParallel, path, t: torch.Tensor, layer):
    """A whole leaf's block for this rank (contiguous: the kernels read
    their operands' strides as their own)."""
    if layer is not None:
        t = t[layer]
    return _narrow(t, tp.cuts(path)).contiguous()


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, computed without
    making one (a tensor made under a dry run's counter would count)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


class _MeshFetch:
    """One leaf of a DTensor tree as a plain local tensor for this rank:
    one layer's slice of a stacked leaf (its placements one dim down),
    its data dims gathered (grad ``Partial``: the backward reduce-scatters
    the gradient over them). Its "model" dim: kept where the local shard
    is the rank's block (grad stays local to the shard); where the leaf
    is whole on every "model" rank (replicated: Mixtral's 8 experts on 16
    ranks) and no cut falls on a data-sharded dim, cut first and only the
    rank's block gathered over the data axes (the leaf's gradient then
    ``Partial`` over "model": each rank's block's, summed where the step
    lays the gradient out as the leaf, ``sum_model_partials``); where the
    rank's cut is several ranges of the dim the leaf is sharded on over
    "model" (Mamba2's ``w_in`` and ``conv_w``), kept and the ranges
    brought to the rank (``TensorParallel.gather_ranges``: an all-to-all,
    the gradient sent back to the shards); else gathered and cut (grad
    ``Partial`` over "model": the ranks' contributions summed). An MoE leaf of fewer experts than ranks is cut
    on two dims, its expert and its columns. A leaf the rank uses whole (a
    norm scale, the router, a replicated head) is gathered with a
    ``Replicate`` grad: every rank computes the same gradient for it.
    Mesh dims of size 1 are left alone, so a one-rank mesh reads views of
    the local tensors.

    With ``stage`` a stacked leaf is a pod pipeline's stage-stacked one,
    (n_pods, L/P, ...) with the stage dim ``Shard(0)`` over "pod": layer j
    is entry j of this rank's own pod's shard, nothing moves over "pod",
    and each layer fetched is kept for the fetch's life (a pipeline runs
    every layer of its stage once a tick: each is gathered once a step)."""

    def __init__(self, mesh, stage: bool = False):
        self.mesh = mesh
        self.sizes = tuple(mesh.shape)
        self.coord = mesh.get_coordinate()
        self.stage = stage
        self._local = {}
        self._kept = {}

    def __call__(self, tp, path, t, layer):
        if not (self.stage and layer is not None):
            return self._fetch(tp, path, t, layer)
        key = (id(t), layer)
        got = self._kept.get(key)
        if got is None:
            got = self._kept[key] = self._fetch(tp, path, t, layer)
        return got

    def _fetch(self, tp, path, t, layer):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        names = self.mesh.mesh_dim_names
        pl, shape = list(t.placements), tuple(t.shape)
        staged = self.stage and layer is not None
        if layer is not None:
            # a layer's placements: its stacked dims dropped; a stage's
            # "pod" shard is this rank's own pod, whole here
            lead = 2 if staged else 1
            pl = [Replicate() if staged and n == "pod"
                  else Shard(p.dim - lead) if isinstance(p, Shard) else p
                  for n, p in zip(names, pl)]
            shape = shape[lead:]
        cuts = tp.cuts(path)
        mi = names.index("model")
        first = (bool(cuts) and self.sizes[mi] > 1
                 and isinstance(pl[mi], Replicate)
                 and not any(isinstance(p, Shard)
                             and p.dim in {c[0] % len(shape) for c in cuts}
                             for p in pl))
        # one local view a leaf for the whole step: its layers' gradients
        # then add up in one plain buffer, as the unsharded step's do,
        # where a view a layer would hold a stacked DTensor gradient each
        loc = self._local.get(id(t))
        if loc is None:
            grad = None
            if first:
                grad = list(t.placements)
                grad[mi] = Partial()
            loc = self._local[id(t)] = t.to_local(grad_placements=grad)
        if layer is not None:
            loc = loc[0][layer] if staged else loc[layer]
        if first:
            # the cut is local: every dim it cuts is whole on this rank
            loc = _narrow(loc, cuts)
            shape = tuple(loc.shape[d] if any(c[0] % len(shape) == d
                                              for c in cuts) else n
                          for d, n in enumerate(shape))
            cuts = ()
        target, grad, cut, ranged = [], [], (), None
        for i, (axis, p) in enumerate(zip(names, pl)):
            if self.sizes[i] == 1 or (first and axis == "model") \
                    or (staged and axis == "pod"):
                target.append(p)
                grad.append(p)
            elif axis != "model":
                target.append(Replicate())
                grad.append(Partial())
            elif not cuts:
                target.append(Replicate())
                grad.append(Replicate())
            elif self._is_shard(p, cuts, shape, i):
                target.append(p)
                grad.append(p)
            elif self._ranged(p, cuts, shape):
                target.append(p)
                grad.append(p)
                ranged = shape[p.dim] // self.sizes[i]
            else:
                target.append(Replicate())
                grad.append(Partial())
                cut = cuts
        if target != pl or grad != pl:
            loc = DTensor.from_local(
                loc, self.mesh, pl, run_check=False, shape=shape,
                stride=contiguous_stride(shape)).redistribute(
                self.mesh, target).to_local(grad_placements=grad)
        if ranged is not None:
            loc = tp.gather_ranges(loc, path, ranged)
        return _narrow(loc, cut)

    @staticmethod
    def _ranged(p, cuts, shape) -> bool:
        """Whether the one cut is several ranges of the dim ``p`` shards."""
        from torch.distributed.tensor import Shard
        return (len(cuts) == 1 and len(cuts[0]) == 2
                and isinstance(p, Shard) and p.dim == cuts[0][0] % len(shape))

    def _is_shard(self, p, cuts, shape, i) -> bool:
        """Whether mesh dim ``i``'s shard (placement ``p``) is this rank's
        one cut."""
        from torch.distributed.tensor import Shard
        if len(cuts) != 1 or len(cuts[0]) != 3 or not isinstance(p, Shard):
            return False
        dim, lo, hi = cuts[0]
        dim %= len(shape)
        n = shape[dim] // self.sizes[i]
        return p.dim == dim and (self.coord[i] * n,
                                 self.coord[i] * n + n) == (lo, hi)


def sum_model_partials(grad, param):
    """A parameter's gradient (a DTensor) laid out as the parameter is:
    a gradient ``Partial`` over "model" (a leaf every "model" rank holds
    whole and cuts its own block of, ``_MeshFetch``) summed over it; any
    other as it is."""
    if tuple(grad.placements) == tuple(param.placements):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)
