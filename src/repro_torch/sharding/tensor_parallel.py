"""Tensor parallelism over the "model" mesh axis for the dense attention
stack: GQA attention, the gated and non-gated FFN, and the vocabulary.

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
* **FFN.** ``w_up`` and ``w_gate`` by columns (``ffn_mask`` sliced with
  them), ``w_down`` by rows, its partial sums all-reduced.
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
``size``, ``all_reduce``, ``all_gather`` and ``all_to_all``: ``GroupAxis`` over a process
group (a mesh's "model" group), or ``SequentialRanks``, which runs the
shares of an n-rank split in one process one after another, each reduction
adding the shares in rank order (the card's two-rank check, and tests).

Parameters reach a layer through ``TensorParallel.layer``: on a mesh
(``on_mesh``) one layer's slice of each stacked DTensor, its data dims
gathered (FSDP-style) and its "model" shard kept where it is the rank's
block, else gathered over "model" and sliced; the gather's backward is the
reduce-scatter of the gradient (``Partial`` grad placements on the dims
it gathered). Whole trees (``sliced``) are sliced per rank with no
communication. A one-rank axis takes every shortcut: the unsharded
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
never the cache; a replicated cache is read where it is.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: what a step's record says of the "model" axis, by route
ROUTE_SPLIT = "split: heads, FFN columns, vocabulary"
ROUTE_REPLICATED = ("replicated: every rank gathers the whole parameter "
                    "tree and computes its data rows whole; tensor "
                    "parallelism over 'model' is ported for the dense "
                    "attention stack only")


def tp_supported(cfg) -> bool:
    """Whether ``cfg`` is the dense attention stack: GQA attention and a
    dense FFN in every layer, no MoE, SSM, shared block or MTP head."""
    return (cfg.arch_type in ("dense", "audio", "vlm")
            and cfg.attention == "gqa" and cfg.moe is None
            and not cfg.shared_attn_period and not cfg.mtp_depth
            and bool(cfg.num_heads))


def mesh_route(cfg) -> str:
    """The route a mesh step takes for ``cfg``: ``ROUTE_SPLIT`` for the
    dense attention stack, ``ROUTE_REPLICATED`` (the whole-tree
    gather) for the rest."""
    return ROUTE_SPLIT if tp_supported(cfg) else ROUTE_REPLICATED


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
    def __init__(self, ranks: SequentialRanks, rank: int):
        self.ranks, self.rank, self.size = ranks, rank, ranks.size

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        def combine(ts):
            out = ts[0]
            for s in ts[1:]:
                out = torch.maximum(out, s) if op == "max" else out + s
            return out
        return self.ranks.exchange(self.rank, t, combine)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.ranks.exchange(self.rank, t, torch.stack)

    def all_to_all(self, parts, shapes) -> List[torch.Tensor]:
        sent = self.ranks.exchange(self.rank, list(parts), list)
        got = [sent[r][self.rank] for r in range(self.size)]
        for r, (t, shape) in enumerate(zip(got, shapes)):
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"rank {self.rank} expected {tuple(shape)} "
                                 f"from rank {r}, got {tuple(t.shape)}")
        return got


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
               axis) -> torch.Tensor:
    """``softmax_xent`` of logits split over "model" (this rank's columns
    [lo, lo + logits.shape[-1])), in fp32: the row max and the sum of
    exponentials all-reduced, the gold logit from the rank holding it;
    labels < 0 masked out, the sum over max(count, 1)."""
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
    return nll.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# a rank's plan and its parameters
# ---------------------------------------------------------------------------
_Q, _KV, _FFN, _VOCAB = "q", "kv", "ffn", "vocab"
#: leaf name -> (dim of one layer's leaf, the unit its block counts)
_SPLIT = {"wq": (-1, _Q), "bq": (-1, _Q), "wk": (-1, _KV), "bk": (-1, _KV),
          "wv": (-1, _KV), "bv": (-1, _KV), "wo": (0, _Q),
          "w_up": (-1, _FFN), "w_gate": (-1, _FFN), "w_down": (0, _FFN),
          "embed": (0, _VOCAB), "lm_head": (-1, _VOCAB)}


class TensorParallel:
    """One rank's share of the dense attention stack: its head block
    (``heads``), FFN columns (``ffn``), vocabulary rows (``vocab``, None
    where the head is replicated) and KV cache shard, the "model" axis its
    reductions go through, and ``fetch``, which hands it parameters:
    ``fetch(name, tensor, layer)`` with ``self.range(name)``."""

    def __init__(self, cfg, axis, fetch):
        if not tp_supported(cfg):
            raise ValueError(f"{cfg.name}: tensor parallelism covers the "
                             f"dense attention stack only")
        self.cfg, self.axis, self._fetch = cfg, axis, fetch
        m, r = axis.size, axis.rank
        self._heads_all = head_split(cfg.num_heads, cfg.num_kv_heads, m)
        self.heads = self._heads_all[r]
        self.ffn = blocks(cfg.d_ff, m)[r]
        V = cfg.padded_vocab
        self.vocab = ((r * V // m, (r + 1) * V // m)
                      if m > 1 and V % m == 0 else None)
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
        self._params = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def sliced(cls, cfg, params, axis) -> "TensorParallel":
        """The share of rank ``axis.rank`` of a whole (plain) parameter
        tree: each leaf sliced to the rank's block, no communication."""
        tp = cls(cfg, axis, _slice_leaf)
        tp._params = params
        return tp

    @classmethod
    def on_mesh(cls, cfg, mesh, params) -> "TensorParallel":
        """This rank's share on ``mesh`` of a DTensor tree laid out by
        ``param_specs``: its "model" axis is the mesh's "model" group."""
        names = mesh.mesh_dim_names
        i = names.index("model")
        axis = GroupAxis(mesh.get_group(i), mesh.get_local_rank(i),
                         mesh.size(i))
        tp = cls(cfg, axis, _MeshFetch(mesh))
        tp._params = params
        return tp

    # -- ranges and parameters ------------------------------------------------
    def range(self, name: str) -> Optional[Tuple[int, int, int]]:
        """(dim, lo, hi) of this rank's block of one layer's leaf
        ``name`` (or of ``embed`` / ``lm_head``), None for a leaf the rank
        uses whole."""
        if name not in _SPLIT:
            return None
        dim, unit = _SPLIT[name]
        D = self.cfg.head_dim
        if unit == _Q:
            lo, hi = self.heads.q
            return dim, lo * D, hi * D
        if unit == _KV:
            lo, hi = self.heads.kv
            return dim, lo * D, hi * D
        if unit == _FFN:
            return (dim,) + self.ffn
        if self.vocab is None:
            return None
        return (dim,) + self.vocab

    def _leaf(self, name, t, layer=None):
        return self._fetch(self, name, t, layer)

    def layer(self, run: int, j: int):
        """Layer ``j`` of run ``run``: every leaf this rank's block of it."""
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else
                    self._leaf(k, v, j) for k, v in tree.items()}
        return walk(self._params["runs"][run])

    def top(self, name: str) -> torch.Tensor:
        return self._leaf(name, self._params[name])

    def mask(self, mask):
        """A layer's masks sliced to this rank's heads and FFN columns."""
        if not mask:
            return mask
        out = dict(mask)
        if out.get("head_mask") is not None:
            out["head_mask"] = out["head_mask"][slice(*self.heads.q)]
        if out.get("ffn_mask") is not None:
            out["ffn_mask"] = out["ffn_mask"][slice(*self.ffn)]
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
        (module docstring)."""
        from repro_torch.models.layers.attention import decode_attention
        rows = torch.arange(k.shape[0], device=k.device)
        if not self.kv_local:
            k, v = self._to_shard(torch.stack([k, v]), 2).unbind(0)
        cache.k[rows, slot] = k
        cache.v[rows, slot] = v
        if self.kv_layout == "dims" and not self.kv_local:
            return self._dims_attention(q, cache, valid, pos, window, scale)
        k0, k1 = self.heads.kv
        kc, vc = (c if self.kv_local else c.narrow(2, k0, k1 - k0)
                  for c in (cache.k, cache.v))
        return decode_attention(q, *self.kv_for_q(kc, vc), valid, pos,
                                window, scale)

    def _dims_attention(self, q, cache, valid, pos, window, scale):
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
                               scale, partial_sum=self.axis.all_reduce)
        return torch.cat(self.axis.all_to_all(
            [out[:, :, lo:hi] for lo, hi in qb],
            [(B, 1, nq, b - a) for a, b in dims]), dim=-1)

def _narrow(t: torch.Tensor, rng) -> torch.Tensor:
    if rng is None:
        return t
    dim, lo, hi = rng
    dim %= t.dim()
    if lo == 0 and hi == t.shape[dim]:
        return t
    return t.narrow(dim, lo, hi - lo)


def _slice_leaf(tp: TensorParallel, name: str, t: torch.Tensor, layer):
    """A whole leaf's block for this rank (contiguous: the kernels read
    their operands' strides as their own)."""
    if layer is not None:
        t = t[layer]
    return _narrow(t, tp.range(name)).contiguous()


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
    the gradient over them), its "model" dim kept where the local shard is
    the rank's block (grad stays local to the shard), else gathered and
    sliced (grad ``Partial`` over "model": the ranks' contributions
    summed). A leaf the rank uses whole (a norm scale, a replicated head)
    is gathered with a ``Replicate`` grad: every rank computes the same
    gradient for it. Mesh dims of size 1 are left alone, so a one-rank
    mesh reads views of the local tensors."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = tuple(mesh.shape)
        self.coord = mesh.get_coordinate()
        self._local = {}

    def __call__(self, tp, name, t, layer):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        # one local view a leaf for the whole step: its layers' gradients
        # then add up in one plain buffer, as the unsharded step's do,
        # where a view a layer would hold a stacked DTensor gradient each
        loc = self._local.get(id(t))
        if loc is None:
            loc = self._local[id(t)] = t.to_local()
        pl, shape = list(t.placements), tuple(t.shape)
        if layer is not None:
            loc = loc[layer]
            pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                  for p in pl]
            shape = shape[1:]
        rng = tp.range(name)
        target, grad, cut = [], [], None
        for i, (axis, p) in enumerate(zip(self.mesh.mesh_dim_names, pl)):
            if self.sizes[i] == 1:
                target.append(p)
                grad.append(p)
            elif axis != "model":
                target.append(Replicate())
                grad.append(Partial())
            elif rng is None:
                target.append(Replicate())
                grad.append(Replicate())
            else:
                dim, lo, hi = rng
                dim %= len(shape)
                n = shape[dim] // self.sizes[i]
                if (isinstance(p, Shard) and p.dim == dim
                        and (self.coord[i] * n, self.coord[i] * n + n)
                        == (lo, hi)):
                    target.append(p)
                    grad.append(p)
                else:
                    target.append(Replicate())
                    grad.append(Partial())
                    cut = rng
        if target != pl or grad != pl:
            loc = DTensor.from_local(
                loc, self.mesh, pl, run_check=False, shape=shape,
                stride=contiguous_stride(shape)).redistribute(
                self.mesh, target).to_local(grad_placements=grad)
        return _narrow(loc, cut) if cut is not None else loc
