"""Step functions the launchers train and serve through (the reference's
``launch/steps.py``): one optimizer step, prefill and decode.

Each step runs on one device, the card unless the caller passes
``device="cpu"`` (``device.resolve_device``): the step moves its batch
there (tokens and labels as int64, an audio config's ``embeds`` and a VLM
config's ``vision_embeds`` in the model's dtype, ``mrope_positions`` as
int32), and the parameters, optimizer state and cache must already live
there. The train step differentiates ``loss_fn`` by autograd with the
forward on the kernels: on the card the ``rmsnorm`` kernel and its gated
entry, ``masked_matmul``, ``flash_attention`` and ``ssd_scan``, each an
autograd Function whose backward is in PyTorch ops. Every family of the
registry trains there, the ``ssm`` and ``hybrid`` ones included; nothing
falls back to the plain versions.

Given a ``mesh`` (a ``DeviceMesh``, ``launch.mesh``), the steps are the
sharded ones, the counterpart of the reference's ``jax.jit`` with
``in_shardings``: the parameters and the optimizer state are DTensor trees
(``sharding.specs.distribute`` by ``param_specs`` and
``opt_state_specs``), each rank reads its ``batch_specs`` rows of the
batch, and each step names its route (``step.route``,
``sharding.tensor_parallel.mesh_route``): the **split** route, for every
stack of the registry (Qwen2-7B, Qwen2-VL-7B, gemma-7b, qwen1.5-4b,
nemotron-4-340b, HuBERT-XLarge, Mixtral-8x7B, DeepSeek-V3, Mamba2-2.7B,
Zamba2-1.2B). The products split over "model" (``sharding.
tensor_parallel``: heads, FFN columns, experts, SSD heads, the
vocabulary), each layer's parameters fetched one layer at a time with
their data dims gathered, no copy of the whole tree; the MoE dispatch and
the router and MTP losses are the whole batch's over the data axes, as
the reference computes them. The train step differentiates the loss with
respect to the DTensor leaves: a "model"-split leaf's gradient stays on
its shard, and the data axes' reduction is the gather's backward (a
reduce-scatter). The prefill writes each rank's cache shard as
``cache_specs`` lays it out (KV heads or head dims, MLA latent dims, SSD
state heads, conv channels), and the decode step writes the new slot or
row into it in place and reads it where it lies: the queries, or a
Mamba2 layer's conv rows, move, never the cache.

The data axes take a batch as ``batch_specs`` does
(``sharding.context_parallel.data_split``): its rows where they divide
them, else its sequence where that divides them (context parallelism:
each rank its block of the positions, the cache's slots over the data
axes, ``sharding.context_parallel``), else every rank holds everything.
Every step takes all three: the train step differentiates through the
sequence split's exchanges (each all-gather's backward a reduce-scatter
over the data axes), and on a whole batch weights each rank's loss by
1/n.

Each rank updates its own shards, AdamW's clip on the norm of the whole
gradient; the prefill returns its logits and cache as DTensors (rows over
the data axes, the cache laid out by ``cache_specs``), and the decode step
writes the updated rows back into the DTensor cache's own shards in
place.

Every step takes ``backend``: ``"auto"`` (the kernels on the card) or
``"ref"`` (the plain versions, as the dry run traces them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, same_memory
from repro_torch.kernels.flash_attention.ops import check_head_dim
from repro_torch.models import transformer as tr
from repro_torch.optim.optimizers import (Optimizer, tree_leaves, tree_map,
                                          value_and_grad)
from repro_torch.sharding import specs as shard_specs
from repro_torch.sharding.context_parallel import (SeqSplit, cache_max_len,
                                                   data_split, label_share)
from repro_torch.sharding.tensor_parallel import (TensorParallel,
                                                  contiguous_stride,
                                                  data_axes, mesh_route,
                                                  sum_model_partials)


def _on(device: torch.device, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(device=device, dtype=torch.long)


def batch_on(device: torch.device, cfg: ModelConfig, batch):
    """``batch`` with each of its inputs on ``device`` in the type the
    stack reads it in."""
    dtype = getattr(torch, cfg.dtype)
    types = {"tokens": torch.long, "labels": torch.long, "embeds": dtype,
             "vision_embeds": dtype, "mrope_positions": torch.int32}
    return {name: (torch.as_tensor(t).to(device=device, dtype=types[name])
                   if name in types else t) for name, t in batch.items()}


def _check_card(cfg: ModelConfig, dev: torch.device) -> None:
    """Refuse on the card a config whose attention goes through the flash
    kernel (GQA) at a head dim the kernel has no instance of; MLA's
    attention never reaches that kernel."""
    if dev.type == "cuda" and cfg.num_heads and cfg.attention == "gqa":
        check_head_dim(cfg.head_dim)


def _microbatches(batch, n: int):
    """``batch`` split into ``n`` equal microbatches on the batch dim: dim
    0, except ``mrope_positions`` (3, B, S), split on dim 1."""
    def split(name, t):
        dim = 1 if name == "mrope_positions" else 0
        if t.shape[dim] % n:
            raise ValueError(f"grad_accum {n} does not divide {name}'s "
                             f"batch dim {t.shape[dim]}")
        return torch.chunk(t, n, dim=dim)
    parts = {name: split(name, t) for name, t in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(n)]


def loss_and_grads(params, cfg: ModelConfig, batch, masks=None,
                   backend: str = "auto", tp_of=None, share=None):
    """(metrics, grads): ``loss_fn``'s metrics, detached, and its gradient
    with respect to every leaf of ``params`` (``optim.value_and_grad``),
    on the device the parameters and ``batch`` already live on; the
    kernel path (``backend="auto"``) or the plain versions (``"ref"``).
    ``tp_of(leaves)``, where given, is the tensor-parallel share the loss
    runs as (``sharding.tensor_parallel.TensorParallel``); ``share``, where
    given, weights the loss in float32 before it is differentiated."""
    out = {}

    def loss(p):
        tp = None if tp_of is None else tp_of(p)
        total, out["metrics"] = tr.loss_fn(p, cfg, batch, masks, backend,
                                           tp=tp)
        return total if share is None else total.to(torch.float32) * share
    _, grads = value_and_grad(loss, params)
    return {k: v.detach() for k, v in out["metrics"].items()}, grads


def share_loss_and_grads(cfg: ModelConfig, params, batch, axis,
                         masks=None, backend: str = "auto",
                         split: str = "sequence"):
    """(metrics, grads, share) of one data rank's share of a train step
    split over ``axis`` (a data seam: a ``tensor_parallel`` ``DataAxes``,
    a ``SequentialRanks`` rank, or any axis with ``rank``, ``size``,
    ``all_gather``, ``all_reduce``, ``reduce_scatter`` and
    ``all_to_all``), of a whole (plain) tree ``params`` and the whole
    ``batch``, "model" whole: ``loss_and_grads`` of the rank's part
    weighted by its share of the labelled tokens. ``split`` is how the
    batch lies over ``axis``: ``"sequence"``, each rank its block of the
    positions (``TensorParallel.sliced`` with ``SeqSplit(axis)``, the share
    ``context_parallel.label_share``), or ``"rows"``, each rank its
    contiguous rows (``mrope_positions`` on dim 1). The ranks' gradients
    sum to the whole batch's, and their metrics, each times its share, to
    its metrics."""
    from repro_torch.sharding.tensor_parallel import SequentialRanks
    model = SequentialRanks(1).axes()[0]
    if split == "rows":
        seq = None
        rows = batch["labels"].shape[0] // axis.size
        cut = slice(axis.rank * rows, (axis.rank + 1) * rows)
        mine = {k: v[:, cut] if k == "mrope_positions" else v[cut]
                for k, v in batch.items()}
        share = _rows_share(mine["labels"], batch["labels"])
        batch = mine
    else:
        seq = SeqSplit(axis)
        share = label_share(cfg, batch["labels"], seq)
    metrics, grads = loss_and_grads(
        params, cfg, batch, masks, backend,
        tp_of=lambda p: TensorParallel.sliced(cfg, p, model, data=axis,
                                              seq=seq),
        share=share)
    return metrics, grads, share


def _accumulated(grads_of, params, batch, grad_accum: int):
    """(metrics, grads) of ``batch`` by ``grads_of(params, microbatch)``:
    one call where ``grad_accum`` is 1, else one a microbatch
    (``_microbatches``), their gradients summed in fp32, divided by
    ``grad_accum`` and cast to each parameter's dtype, their metrics
    averaged."""
    if grad_accum == 1:
        return grads_of(params, batch)
    gsum, ms = None, []
    for mb in _microbatches(batch, grad_accum):
        m, g = grads_of(params, mb)
        g = tree_map(lambda t: t.to(torch.float32), g)
        gsum = g if gsum is None else tree_map(torch.add, gsum, g)
        del g
        ms.append(m)
    grads = tree_map(lambda g, p: (g / grad_accum).to(p.dtype), gsum, params)
    del gsum
    return ({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]},
            grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, masks=None,
                    grad_accum: int = 1, device: DeviceLike = None,
                    mesh=None, backend: str = "auto"):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (``optim.value_and_grad`` of
    ``loss_fn``), then ``optimizer.update``, as the reference's step.
    ``batch`` holds ``labels`` (B, S) beside the inputs ``prefill`` takes.
    ``grad_accum > 1`` runs the batch as that many microbatches
    (``_microbatches``), sums their gradients in fp32, divides by
    ``grad_accum`` and casts each to its parameter's dtype, and averages
    the metrics: live activations shrink by the factor. With ``mesh`` the
    step is the sharded one (``_tp_train_step``; ``step.route`` names
    it): its ``params`` and ``opt_state`` are DTensor trees on ``mesh``
    and ``batch`` the whole batch, which every rank holds."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)
    if mesh is not None:
        step = _tp_train_step(cfg, optimizer, masks, grad_accum, backend,
                              dev, mesh)
        step.route = mesh_route(cfg)
        return step

    def grads_of(params, batch):
        return _accumulated(
            lambda p, mb: loss_and_grads(p, cfg, mb, masks, backend),
            params, batch, grad_accum)

    def train_step(params, opt_state, batch):
        metrics, grads = grads_of(params, batch_on(dev, cfg, batch))
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics
    return train_step


def _data_size(mesh) -> int:
    """Ranks along the mesh's data axes."""
    data, _ = shard_specs.mesh_axes(mesh)
    sizes = shard_specs.axis_sizes(mesh)
    n = 1
    for a in data:
        n *= sizes[a]
    return n


def _check_mesh(mesh, dev: torch.device) -> None:
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the step on "
                         f"{dev.type}")


def _my_rows(batch, mesh, split: bool):
    """This rank's rows of every input of ``batch`` where ``split``, else
    all of them (``mrope_positions`` holds its rows on dim 1; a sequence
    split's block is cut by the stack, ``transformer.embed_inputs``, after
    a VLM's vision prefix is joined)."""
    def rows(name, t):
        t = torch.as_tensor(t)
        bdim = 1 if name == "mrope_positions" else 0
        return shard_specs.local_slice(
            t, shard_specs.P(*_rows_spec(mesh, bdim, split)), mesh)
    return {name: rows(name, t) for name, t in batch.items()}


def _rows_spec(mesh, bdim: int, split: bool) -> list:
    data, _ = shard_specs.mesh_axes(mesh)
    return [None] * bdim + [data if split else None]


def _rows_split(B: int, mesh) -> bool:
    """Whether a batch of ``B`` rows splits over the data axes (else every
    rank holds them all)."""
    n = _data_size(mesh)
    return n > 1 and B % n == 0


def _rows_placements(mesh, bdim: int, split: bool) -> tuple:
    """Placements of a tensor whose dim ``bdim`` holds the batch rows:
    sharded over the data axes where ``split``, whole on "model"."""
    return shard_specs.placements(
        shard_specs.P(*_rows_spec(mesh, bdim, split)), mesh)


def _cache_bdim(path) -> int:
    """The batch dim of a cache leaf: 0 for ``pos`` (B,), else 1 (a run's
    or the shared block's stacked (L, B, ...))."""
    return 0 if shard_specs.path_keys(path)[-1] == "pos" else 1


def _rows_dtensor(t: torch.Tensor, mesh, bdim: int, split: bool):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, _rows_placements(mesh, bdim, split),
                              run_check=False)


def _laid_out(cache, cfg: ModelConfig, mesh):
    """A DTensor cache redistributed to ``cache_specs``' layout."""
    specs = shard_specs.cache_specs(cache, cfg, mesh)
    return shard_specs.tree_map_with_path(
        lambda _, sp, t: t.redistribute(mesh,
                                        shard_specs.placements(sp, mesh)),
        specs, cache, is_leaf=shard_specs._is_spec)


def _batch_rows(cfg: ModelConfig, batch) -> int:
    name = "embeds" if cfg.embeds_input else "tokens"
    return torch.as_tensor(batch[name]).shape[0]


def _batch_positions(cfg: ModelConfig, batch) -> int:
    """The sequence length the stack runs (a VLM's vision prefix
    counted)."""
    name = "embeds" if cfg.embeds_input else "tokens"
    return torch.as_tensor(batch[name]).shape[1] + (cfg.vision_tokens or 0)


def _data_split(cfg: ModelConfig, batch, mesh) -> str:
    """``"rows"``, ``"sequence"`` or ``"whole"``: how ``batch`` lies over
    the mesh's data axes (``context_parallel.data_split``)."""
    return data_split(_batch_rows(cfg, batch), _batch_positions(cfg, batch),
                      _data_size(mesh))


def _my_batch(cfg: ModelConfig, batch, mesh, dev: torch.device, mode: str):
    """(what this rank holds of ``batch`` on ``dev``, its share of the
    loss) as the batch lies over the data axes (``mode``, a
    ``context_parallel.data_split`` word): ``"rows"``, its rows, the share
    their labelled tokens over the whole batch's; ``"sequence"``, every
    row (the stack cuts its block of the positions), the share its
    block's labelled tokens (a VLM's labels padded over the vision
    prefix, as ``loss_fn`` cuts them) over the whole batch's;
    ``"whole"``, everything, the share 1/n. The share is divided in
    float64 and rounded once, as a float32 tensor times a Python float
    rounds it; a tensor, so that a traced step reads no value."""
    local = batch_on(dev, cfg, _my_rows(batch, mesh, mode == "rows"))
    if mode == "whole":
        return local, torch.tensor(1.0 / _data_size(mesh), device=dev)
    if mode == "sequence":
        return local, label_share(cfg, local["labels"],
                                  SeqSplit(data_axes(mesh)))
    return local, _rows_share(local["labels"],
                              torch.as_tensor(batch["labels"]))


def _rows_share(mine: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """A data rank's share of the loss where the rows split: its rows'
    labelled tokens (``mine``) over the whole batch's (``labels``, counted
    where they lie), divided in float64 and rounded once to float32."""
    f64 = torch.float64
    total = (labels >= 0).sum().to(mine.device, f64)
    return ((mine >= 0).sum().to(f64)
            / total.clamp_min(1.0)).to(torch.float32)


def _data_sum(metrics, share, mesh):
    """Each metric weighted by this rank's ``share`` in float32 and summed
    over the data axes (as it is, where they have one rank)."""
    import torch.distributed as dist
    if _data_size(mesh) == 1:
        return metrics
    data, _ = shard_specs.mesh_axes(mesh)
    out = {}
    for k, v in metrics.items():
        out[k] = v = v.to(torch.float32) * share
        for a in data:
            dist.all_reduce(v, group=mesh.get_group(a))
    return out


def _update_shards(optimizer: Optimizer, grads, params, opt_state, mesh):
    """(params, opt_state) after ``optimizer.update`` of this rank's own
    shards by its local ``grads``, AdamW's clip on the whole gradient's
    norm (``_mesh_sq_norm``), wrapped back as DTensors placed as
    ``params``."""
    from torch.distributed.tensor import DTensor
    placed = [p.placements for p in tree_leaves(params)]
    local_params = tree_map(lambda p: p.to_local(), params)
    state = {k: (tree_map(lambda t: t.to_local(), v)
                 if k != "step" else v) for k, v in opt_state.items()}
    new_params, new_state = optimizer.update(
        grads, state, local_params,
        sq_norm=lambda g: _mesh_sq_norm(g, placed, mesh))
    del grads, local_params, state

    def wrap(t, p):
        return DTensor.from_local(t, mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return (tree_map(wrap, new_params, params),
            {k: (tree_map(wrap, v, params) if k != "step" else v)
             for k, v in new_state.items()})


def _kv_placements(mesh, tp, split: bool, name: str,
                   slots: bool = False) -> tuple:
    """Placements of a stacked cache leaf ``name``, a KV leaf (L, B, S,
    heads, D), an MLA leaf (L, B, S, width), an SSD state (L, B, heads, P,
    N) or a conv tail (L, B, K-1, channels), holding this rank's rows (over
    the data axes where ``split``), or its block of the slots S (where
    ``slots``: a sequence split's), and its "model" shard
    (``tp.kv_layout``, ``tp.latent_layouts``, ``tp.state_layout``,
    ``tp.conv_layout``)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(2) if slots and isinstance(p, Shard) else p
          for p in _rows_placements(mesh, 1, split or slots)]
    if name in ("ckv", "krope"):
        lay = tp.latent_layouts[name == "krope"]
        dim = 3 if lay == "dims" else None
    elif name == "state":
        dim = 2 if tp.state_layout == "heads" else None
    elif name == "conv":
        dim = 3 if tp.conv_layout == "dims" else None
    else:
        dim = {"heads": 3, "dims": 4}.get(tp.kv_layout)
    pl[mesh.mesh_dim_names.index("model")] = (
        Replicate() if dim is None else Shard(dim))
    return tuple(pl)


def _tp_prefill_step(cfg: ModelConfig, max_len, masks, backend: str,
                     dev: torch.device, mesh):
    """The prefill on ``mesh`` on the split route: this rank's rows where
    they divide the data axes, else its block of the sequence where that
    does (``context_parallel``), else everything; its share of every
    product (``TensorParallel.on_mesh``; the MoE dispatch over the data
    axes where they split the rows or the sequence), the last logits
    gathered over "model"; logits as a DTensor of rows over the data axes
    (a bidirectional config's of the sequence block where the sequence is
    split), the cache as a DTensor tree laid out by ``cache_specs``, each
    rank's shard written from the KV heads the ranks computed (an MLA
    cache: its slice of the latent every rank computed whole; an SSM
    cache: the conv channels and SSD heads the ranks computed,
    ``TensorParallel.store_conv`` and ``store_state``) and, on a sequence
    split, each leaf's slots placed where ``cache_specs`` lays them (its
    block of S over the data axes where they divide it) as the ranks took
    them from the gathered keys: no leaf moves."""
    from torch.distributed.tensor import DTensor, Shard
    _check_mesh(mesh, dev)

    def prefill_step(params, batch):
        B = _batch_rows(cfg, batch)
        mode = _data_split(cfg, batch, mesh)
        split = mode == "rows"
        local = batch_on(dev, cfg, _my_rows(batch, mesh, split))
        S_max = max_len or _batch_positions(cfg, batch)
        tp = TensorParallel.on_mesh(cfg, mesh, params, split=mode,
                                    max_len=S_max)
        logits, cache = tr.prefill(params, cfg, local, max_len=S_max,
                                   masks=masks, backend=backend, tp=tp)
        if mode == "sequence" and not cfg.causal:
            pl = [Shard(1) if isinstance(p, Shard) else p
                  for p in _rows_placements(mesh, 0, True)]
            shape = (B, logits.shape[1] * tp.seq.n) + tuple(logits.shape[2:])
            logits = DTensor.from_local(logits, mesh, pl, run_check=False,
                                        shape=shape,
                                        stride=contiguous_stride(shape))
        else:
            logits = _rows_dtensor(logits, mesh, 0, split)
        if cache is None:
            return logits, None
        def placed(path, t):
            name = shard_specs.path_keys(path)[-1]
            if name == "pos":
                return _rows_dtensor(t, mesh, 0, split)
            lay = _slot_layout(tp.seq, name)
            S_all = t.shape[2] if lay is None else lay.count
            on_slots = lay is not None and lay.split
            if name in ("ckv", "krope"):
                width = (cfg.mla.kv_lora_rank if name == "ckv"
                         else cfg.mla.qk_rope_head_dim)
                shape = (t.shape[0], B, S_all, width)
            elif name == "state":
                shape = (t.shape[0], B, cfg.ssm_heads) + tuple(t.shape[3:])
            elif name == "conv":
                shape = (t.shape[0], B, t.shape[2],
                         cfg.d_inner + 2 * cfg.ssm.n_groups
                         * cfg.ssm.d_state)
            else:
                shape = (t.shape[0], B, S_all, cfg.num_kv_heads,
                         cfg.head_dim)
            return DTensor.from_local(
                t, mesh, _kv_placements(mesh, tp, split, name, on_slots),
                run_check=False, shape=shape,
                stride=contiguous_stride(shape))
        rows = shard_specs.tree_map_with_path(placed, cache)
        if mode == "sequence":
            return logits, rows        # cache_specs' layout already
        return logits, _laid_out(rows, cfg, mesh)
    return prefill_step


def _slot_layout(seq, name: str):
    """The sequence split's layout (a ``context_parallel.Slots``) of the
    slots of cache leaf ``name``: an MLA leaf's ``seq.latent``, a KV
    leaf's ``seq.kv``; None for a leaf without slots or without a
    split."""
    if seq is None or name in ("pos", "state", "conv"):
        return None
    return seq.latent if name in ("ckv", "krope") else seq.kv


def _check_slots(cache, seq) -> None:
    """Refuse a cache whose leaves do not hold this rank's slots of the
    split's layout (``_slot_layout``)."""
    def check(path, t):
        lay = _slot_layout(seq, shard_specs.path_keys(path)[-1])
        if lay is not None and t.to_local().shape[2] != lay.hi - lay.lo:
            raise ValueError(f"cache leaf {shard_specs.path_keys(path)} "
                             f"holds {t.to_local().shape[2]} slots here; "
                             f"the sequence split lays out "
                             f"{lay.hi - lay.lo} of {lay.count}")
    shard_specs.tree_map_with_path(check, cache)


def _tp_decode_step(cfg: ModelConfig, masks, backend: str,
                    dev: torch.device, mesh):
    """The decode step on ``mesh`` on the split route, over a DTensor
    cache (``cache_specs``). Where the tokens' rows divide the data axes,
    each leaf laid out to this rank's rows (as ``cache_specs`` lays it),
    its "model" shard kept, and laid back out and copied into its own
    shards in place after the step; else every leaf stays where it lies,
    a KV or MLA leaf's slots split over the data axes where they divide
    them (``context_parallel``: the slot's owner writes it, the ranks'
    partial softmaxes combined), and no leaf moves. The local step runs on
    this rank's share (``TensorParallel.decode_attention`` writes the new
    slot into the shard and attends where the cache lies), the logits
    gathered over "model"."""
    _check_mesh(mesh, dev)
    mi = mesh.mesh_dim_names.index("model")

    def decode_step(params, cache, tokens):
        tokens = torch.as_tensor(tokens)
        split = _rows_split(tokens.shape[0], mesh)
        local_tok = _on(dev, _my_rows({"tokens": tokens}, mesh,
                                      split)["tokens"])

        def rows(path, t):
            want = list(_rows_placements(mesh, _cache_bdim(path), split))
            want[mi] = t.placements[mi]
            return t.redistribute(mesh, tuple(want))
        held = (shard_specs.tree_map_with_path(rows, cache) if split
                else cache)
        local = shard_specs.tree_map_with_path(lambda _, t: t.to_local(),
                                               held)
        mode = ("rows" if split else
                "slots" if _data_size(mesh) > 1 else "whole")
        tp = TensorParallel.on_mesh(cfg, mesh, params, split=mode,
                                    max_len=cache_max_len(cache))
        _check_slots(cache, tp.seq)
        logits, _ = tr.decode_step(params, cfg, local, local_tok,
                                   masks=masks, backend=backend, tp=tp)
        if split:
            _put_back(cache, held, mesh)
        return (_rows_dtensor(logits, mesh, 0, split),
                dict(cache, pos=cache["pos"] + 1))
    return decode_step


def _put_back(cache, held, mesh) -> None:
    """Each cache leaf's rows of ``held`` (written in place by the local
    step) laid out as the leaf is and copied into its own shards, where
    they are not the same memory already; ``pos`` advances apart."""
    def put_back(path, leaf, rows):
        if shard_specs.path_keys(path)[-1] == "pos":
            return
        mine = rows.redistribute(mesh, leaf.placements).to_local()
        dst = leaf.to_local()
        if not same_memory(dst, mine):
            dst.copy_(mine)
    shard_specs.tree_map_with_path(put_back, cache, held)


def _tp_train_step(cfg: ModelConfig, optimizer: Optimizer, masks,
                   grad_accum: int, backend: str, dev: torch.device, mesh):
    """The train step on ``mesh`` on the split route. Each rank takes what
    ``batch_specs`` gives it of the batch (``_my_batch``: its rows where
    they divide the data axes, else every row and its block of the
    positions where those divide them, else everything) and
    differentiates the loss of its share (``TensorParallel.on_mesh``: each
    layer's data dims gathered inside the layer's remat checkpoint, the
    products split over "model", the vocabulary-parallel cross-entropy;
    on a sequence split K and V, MLA's latents, the conv's halo and the
    SSD state exchanged over the data axes, each exchange's backward
    sending the gradient back to the ranks it came from) with respect to
    the DTensor parameters themselves: a "model"-split leaf's gradient
    stays on its shard, and the gather's backward reduce-scatters the
    gradient over the data axes. The loss is weighted by this rank's share
    first where the data axes have more than one rank (in float32; on one
    rank the unsharded step's loss itself): its share of the labelled
    tokens where the rows or the sequence are split, so the reduction
    gives the whole batch's gradient of the cross-entropy, and 1/n where
    every rank holds the whole batch; the router losses and the MTP loss
    are the whole batch's on every rank (``TensorParallel.batch_sum``),
    and the shares summing to 1, their gradient is the whole batch's too.
    With ``grad_accum`` microbatches the whole batch is cut into the
    unsharded step's microbatches first and each microbatch lies over the
    data axes as its own rows and positions do (16 rows over 32 data
    ranks: a sequence split), so a microbatch's whole-batch sums (the MoE
    dispatch's capacity, slots and drops, the balance losses) run over the
    reference's rows; a rank's share is then its share of the
    microbatch's, the local gradients sum in fp32 and divide, as the
    unsharded step does. The metrics are weighted and summed over the data
    axes; AdamW updates each rank's own shards, its clip on the whole
    gradient's norm (``_mesh_sq_norm``). On a one-rank mesh every fetch is
    a view and every reduction the identity: the unsharded step's bits."""
    _check_mesh(mesh, dev)
    n_data = _data_size(mesh)

    def grads_of(p, mb):
        mode = _data_split(cfg, mb, mesh)
        local, share = _my_batch(cfg, mb, mesh, dev, mode)
        m, g = loss_and_grads(
            p, cfg, local, masks, backend,
            tp_of=lambda leaves: TensorParallel.on_mesh(cfg, mesh, leaves,
                                                        split=mode),
            share=share if n_data > 1 else None)
        return _data_sum(m, share, mesh), tree_map(
            lambda t, q: sum_model_partials(t, q).to_local(), g, p)

    def train_step(params, opt_state, batch):
        batch = {name: torch.as_tensor(t) for name, t in batch.items()}
        metrics, grads = _accumulated(grads_of, params, batch, grad_accum)
        return _update_shards(optimizer, grads, params, opt_state, mesh) + (
            metrics,)
    return train_step


def _mesh_sq_norm(grads, placed, mesh) -> torch.Tensor:
    """The squared norm of the whole gradient from each rank's shards: a
    leaf counts on the ranks at coordinate 0 of every mesh dim it is
    replicated over (each element once), the sums of squares added in the
    tree's order and all-reduced over the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    coord = mesh.get_coordinate()
    total = None
    for g, pl in zip(tree_leaves(grads), placed):
        if any(isinstance(p, Replicate) and c for p, c in zip(pl, coord)):
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(grads)[0].device)
    for d in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(d))
    return total


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None,
                      masks=None, device: DeviceLike = None, mesh=None,
                      backend: str = "auto"):
    """-> ``prefill_step(params, batch) -> (last_logits (B,V), cache)``.
    On the card a config whose attention goes through the flash kernel
    (GQA) but whose head dim the kernel has no instance of is refused
    here, not in its first attention layer; MLA's attention never reaches
    that kernel. ``batch`` holds ``tokens`` (B, S), or an audio config's
    ``embeds`` (B, S, d_model); a VLM config's also ``vision_embeds`` (B,
    V, d_model) and, optionally, ``mrope_positions`` (3, B, V + S). A
    bidirectional config returns (all logits (B, S, V), None). With
    ``mesh`` the step is the sharded one (``_tp_prefill_step``;
    ``step.route`` names it): ``params`` is a DTensor tree, ``batch`` the
    whole batch."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)
    if mesh is not None:
        step = _tp_prefill_step(cfg, max_len, masks, backend, dev, mesh)
        step.route = mesh_route(cfg)
        return step

    def prefill_step(params, batch):
        batch = batch_on(dev, cfg, batch)
        return tr.prefill(params, cfg, batch, max_len=max_len, masks=masks,
                          backend=backend)
    return prefill_step


def make_decode_step(cfg: ModelConfig, masks=None,
                     device: DeviceLike = None, mesh=None,
                     backend: str = "auto"):
    """-> ``decode_step(params, cache, tokens (B,1)) -> (logits (B,V),
    cache)``; the cache's tensors (KV or MLA latent slots, SSD states and
    conv windows) are updated in place. A bidirectional (encoder-only)
    config has no decode step and is refused. With ``mesh`` the step is
    the sharded one (``_tp_decode_step``; ``step.route`` names it):
    ``params`` and ``cache`` are DTensor trees (the mesh prefill's cache),
    ``tokens`` the whole batch's."""
    tr.check_supported(cfg)
    if not cfg.causal:
        raise ValueError(f"{cfg.name}: a bidirectional encoder has no "
                         f"decode step; its prefill returns every "
                         f"position's logits")
    dev = resolve_device(device)
    if mesh is not None:
        step = _tp_decode_step(cfg, masks, backend, dev, mesh)
        step.route = mesh_route(cfg)
        return step

    def decode_step(params, cache, tokens):
        return tr.decode_step(params, cfg, cache, _on(dev, tokens),
                              masks=masks, backend=backend)
    return decode_step
