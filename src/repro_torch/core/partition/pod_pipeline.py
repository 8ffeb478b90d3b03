"""Tier-B split inference on a mesh of pods, the port of the JAX package's
``core/partition/pod_pipeline.py``: the paper's edge/cloud partition
mapped onto the ("pod", "data", "model") mesh.

The split point ``c`` becomes a pod boundary: pod p holds layers
[p*L/P, (p+1)*L/P); the boundary activation crosses pods as a
point-to-point send over the "pod" dim's group (``dist.batch_isend_irecv``:
each rank sends to the rank at its own ("data", "model") coordinate in
the next pod), the counterpart of the reference's ``ppermute`` and the
T_TX term of Eq. 5. A ``roofline.analysis.TraceCounter`` sees each send
as ``"collective-permute"`` bytes.

Execution is the reference's SPMD microbatch pipeline (GPipe-style):
requests are split into ``num_microbatches``; each tick every pod runs its
stage on its current activation, then the activation shifts one pod to
the right. Ticks = microbatches + pods - 1 (fill and drain; every pod
computes every tick, as the reference's scan does).

Inside a stage only "pod" is the pipeline's, as in the reference, whose
shard_map makes "pod" alone manual: each rank computes its share of its
pod's stage on the split route (``sharding.tensor_parallel``: heads, FFN
columns, experts and SSD heads over "model"). A layer of the
stage-stacked tree is the rank's own pod's entry with its FSDP dims
gathered over "data" alone, once a step and kept for every tick
(``TensorParallel.on_mesh(..., stage=True)``). A microbatch's rows split
over "data" where they divide it (the MoE dispatch then over the whole
microbatch on "data"), else its sequence where that divides it, as the
reference's ``shard_acts`` keeps it (context parallelism,
``sharding.context_parallel``: each data rank runs its block of the
positions, K and V gathered over "data", the SSD state carried across
the blocks, the MoE dispatch over the whole microbatch), else every data
rank runs it all. After a block's "model" reductions a rank's activation
is the same on every "model" rank, so each rank sends only its (data,
model) block of it, the reference's ``P(None, "data", "model")`` shard:
its S block (or its rows) on "data", d_model over "model", and the next
pod rebuilds the rank's activation with an all-gather over "model"
before its first layer (and over "data" where every data rank runs the
whole microbatch). The rotary angles do not hop: every rank holds every
microbatch's, and pod p takes microbatch t - p's at tick t. The last
pod's blocks are all-reduced over "pod" in float32 with zeros from the
others (the reference's ``psum``: every pod gets its bits), then gathered
inside each pod. The embedding, the final norm and the head run on the
same split (the vocabulary over "model"), the last position's logits
gathered over "model".

Scope, as the reference's: architectures whose layer stack is a single
homogeneous run (dense GQA, pure MoE, pure SSM; zamba2's shared-block
hybrid and deepseek's dense-then-MoE stack are not) and num_layers %
n_pods == 0.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import _check_card, batch_on
from repro_torch.models import transformer as tr
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.optim.optimizers import tree_map
from repro_torch.sharding import specs as sh
from repro_torch.sharding.context_parallel import data_split
from repro_torch.sharding.tensor_parallel import GroupAxis, TensorParallel

#: what a split-serve step's ``route`` says: its stages on the split route
#: (``sharding.tensor_parallel``), the hop and the result moved as slabs
ROUTE = "split"


def pipeline_supported(cfg: ModelConfig) -> bool:
    runs = tr.layer_runs(cfg)
    return (len(runs) == 1 and not cfg.shared_attn_period
            and runs[0].kind in ("attn", "moe", "ssm"))


def stack_stage_params(params: Dict[str, Any], cfg: ModelConfig,
                       n_stages: int):
    """The single run's (L, ...) weights as (n_stages, L/n, ...): views of
    the stacked tensors where their layout allows. The leading stage dim
    is the one the "pod" mesh axis shards."""
    if not pipeline_supported(cfg):
        raise ValueError(f"{cfg.name}: a single homogeneous run is "
                         f"required")
    L = cfg.num_layers
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    return tree_map(lambda a: a.reshape((n_stages, L // n_stages)
                                        + tuple(a.shape[1:])),
                    params["runs"][0])


def _stage_spec(spec):
    """A stacked leaf's spec: dim 0 (the stage dim, unsharded by the name
    rules) over "pod", and "pod" dropped from any composite ("pod",
    "data") entry of the inner dims (the reference's ``_stage_spec``)."""
    inner = []
    for e in tuple(spec):
        if isinstance(e, tuple) and "pod" in e:
            rest = tuple(a for a in e if a != "pod")
            inner.append(rest[0] if len(rest) == 1 else (rest or None))
        else:
            inner.append(e)
    if inner and inner[0] is not None:
        raise ValueError(f"the stage dim is sharded: {spec}")
    return sh.P(*(("pod",) + tuple(inner[1:])))


def stage_param_specs(params, cfg: ModelConfig, mesh):
    """``sharding.specs.param_specs`` of a tree whose ``runs[0]`` is
    stacked (``stack_stage_params``), the stage dim over "pod"."""
    specs = sh.param_specs(params, cfg, mesh)
    specs["runs"] = [sh.tree_map_with_path(
        lambda _, s: _stage_spec(s), specs["runs"][0], is_leaf=sh._is_spec)]
    return specs


def _stage_apply(cfg: ModelConfig, tp, count: int, x: torch.Tensor,
                 angles: torch.Tensor, backend: str) -> torch.Tensor:
    """This pod's layer range over x (this rank's rows of one
    microbatch), layer by layer, each block this rank's share of it
    (``tp``: a stage's ``TensorParallel``)."""
    kind = tr.layer_runs(cfg)[0].kind
    for j in range(count):
        if kind == "ssm":
            x, _ = tr._ssm_block(cfg, (0, j), x, None, backend, False, tp)
        else:
            x, _, _ = tr._attn_block(cfg, (0, j), x, angles, None, backend,
                                     tp)
    return x


def _span(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Part ``i`` of ``n`` in ``parts`` equal parts; all of it where they
    do not divide."""
    if n % parts:
        return 0, n
    return i * n // parts, (i + 1) * n // parts


class _Slab:
    """This rank's (data, model) block of an activation (rows, S, d): the
    reference's ``P(None, "data", "model")`` shard, S over "data" and d
    over "model" (each where it divides); where the rows or the sequence
    are split over "data" already (``local``: S is the rank's block), d
    over "model" alone. ``cut`` takes the block; ``join`` rebuilds the
    rank's activation from the blocks of its pod (all-gathers over
    "model", then "data", on the block's dims)."""

    def __init__(self, mesh, coord, local: bool, S: int, d: int):
        self.axes = {n: GroupAxis(mesh.get_group(n), coord[n], mesh.size(i))
                     for i, n in ((1, "data"), (2, "model"))}
        self.seq = ((0, S) if local
                    else _span(S, self.axes["data"].size, coord["data"]))
        self.dims = _span(d, self.axes["model"].size, coord["model"])
        self.gather = [(self.axes["model"], -1, self.dims != (0, d)),
                       (self.axes["data"], -2, self.seq != (0, S))]

    def cut(self, h: torch.Tensor) -> torch.Tensor:
        (s0, s1), (e0, e1) = self.seq, self.dims
        return h[..., s0:s1, e0:e1].contiguous()

    def join(self, piece: torch.Tensor) -> torch.Tensor:
        for axis, dim, split in self.gather:
            if split:
                piece = torch.cat(axis.all_gather(piece).unbind(0), dim=dim)
        return piece


def _hop(t: torch.Tensor, pod: int, n_pods: int, peers,
         group) -> torch.Tensor:
    """Send ``t`` one pod right and receive the left pod's: what this pod
    runs next tick (pod 0 receives nothing: None)."""
    import torch.distributed as dist
    nxt, prev = peers
    ops, got = [], None
    if pod < n_pods - 1:
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
    if pod > 0:
        got = torch.empty_like(t)
        ops.append(dist.P2POp(dist.irecv, got, prev, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def make_pipeline_forward(cfg: ModelConfig, n_pods: int,
                          num_microbatches: int, mesh,
                          backend: str = "auto"):
    """-> ``fn(stage_params, x, angles) -> y``: x (B, S, d_model) hidden
    states (the embedding and the head run outside), y (B, S, d_model)
    after all L layers, the same bits on every rank. ``stage_params``
    leaves are (n_pods, L/P, ...) DTensors (``stack_stage_params``, laid
    out by ``stage_param_specs``), each rank's share of its pod's stage
    taken by ``TensorParallel.on_mesh(..., stage=True)``.
    B % num_microbatches == 0."""
    import torch.distributed as dist
    if tuple(mesh.mesh_dim_names) != ("pod", "data", "model"):
        raise ValueError(f"the pipeline runs on a (\"pod\", \"data\", "
                         f"\"model\") mesh, not {mesh.mesh_dim_names}")
    if mesh.size(0) != n_pods:
        raise ValueError(f"the mesh's pod axis is not {n_pods} wide: "
                         f"{mesh}")
    M = num_microbatches

    def pipelined(stage_params, x, angles):
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        pod = coord["pod"]
        B, S, d = x.shape
        if B % M:
            raise ValueError(f"{M} microbatches do not divide batch {B}")
        b, n_data = B // M, mesh.size(1)
        # a microbatch's rows split over "data" where they divide it, else
        # its sequence where that does, else every data rank runs it all
        mode = data_split(b, S, n_data)
        split = mode == "rows"
        tp = TensorParallel.on_mesh(cfg, mesh, {"runs": [stage_params]},
                                    split=mode, stage=True)
        rows = (slice(coord["data"] * b // n_data,
                      (coord["data"] + 1) * b // n_data) if split
                else slice(0, b))
        mb = x.reshape((M, b) + tuple(x.shape[1:]))[:, rows]
        # every rank holds every microbatch's angles: pod p takes
        # microbatch t - p's at tick t, so they need not hop
        amb = angles.reshape((M, b) + tuple(angles.shape[1:]))[:, rows]
        if tp.seq is not None:
            mb, amb = tp.seq.cut(mb, 2), tp.seq.cut(amb, 2)
        count = next(tr._leaves(stage_params)).shape[1]
        slab = _Slab(mesh, coord, mode != "whole", mb.shape[2], d)
        group, peers = None, (None, None)
        if n_pods > 1:
            # this rank's ("data", "model") coordinate in every pod, pod
            # by pod
            group = mesh.get_group("pod")
            ranks = dist.get_process_group_ranks(group)
            peers = (ranks[min(pod + 1, n_pods - 1)], ranks[max(pod - 1, 0)])
        state = None
        outs = [None] * M
        for t in range(M + n_pods - 1):
            i = t - pod                  # the microbatch this pod runs
            live = 0 <= i < M
            if pod == 0:
                x_in = mb[i] if live else torch.zeros_like(mb[0])
            elif state is None:
                x_in = torch.zeros_like(mb[0])
            else:
                x_in = slab.join(state)
            a_in = amb[i] if live else torch.zeros_like(amb[0])
            h = slab.cut(_stage_apply(cfg, tp, count, x_in, a_in, backend))
            if n_pods > 1:
                # each rank's block one pod to the right (the paper's T_TX
                # hop), to the same ("data", "model") coordinate there
                state = _hop(h, pod, n_pods, peers, group)
            # the LAST pod emits microbatch t-(P-1) at tick t
            if pod == n_pods - 1 and live:
                outs[i] = h
        if n_pods == 1:
            y = torch.stack(outs)
        else:
            # the last pod's blocks on every pod: a float32 sum with zeros
            # from the others (the reference's psum), which keeps its bits
            y = (torch.stack(outs).to(torch.float32) if pod == n_pods - 1
                 else torch.zeros((M,) + tuple(h.shape), dtype=torch.float32,
                                  device=x.device))
            dist.all_reduce(y, group=group)
            y = y.to(x.dtype)
        y = slab.join(y)
        if split:
            # every data rank's rows of each microbatch: (data, M, b/data,
            # S, d) -> (M, b, S, d)
            y = slab.axes["data"].all_gather(y).movedim(0, 1)
        elif tp.seq is not None:
            y = tp.seq.gather(y, 2)       # every data rank's S block
        return y.reshape(x.shape)

    return pipelined


def make_split_serve_step(cfg: ModelConfig, n_pods: int,
                          num_microbatches: int, mesh,
                          device: DeviceLike = None, backend: str = "auto"):
    """-> ``step(params, batch) -> last-position logits (B, V)``: embed,
    the pod-pipelined stack, the final norm, the head, on the card unless
    the caller passes ``device="cpu"``, each on this rank's share
    (``TensorParallel.on_mesh``): the vocabulary-parallel embedding, the
    stage split over "model", the head's vocabulary columns at the last
    position, gathered over "model". ``params`` is a
    DTensor tree as from ``init_params`` but with ``params["runs"][0]``
    restacked by ``stack_stage_params`` (leading (n_pods, L/P) dims), laid
    out by ``stage_param_specs``. ``step.route`` names the route."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the step on "
                         f"{dev.type}")
    pipe = make_pipeline_forward(cfg, n_pods, num_microbatches, mesh,
                                 backend)

    def step(params, batch):
        batch = batch_on(dev, cfg, batch)
        tp = TensorParallel.on_mesh(cfg, mesh, params)
        x, B, S = tr.embed_inputs(params, cfg, batch, tp)
        angles = tr._angles_for(cfg, batch, B, S, 0, x.device)
        if angles is None:
            angles = torch.zeros((B, S, max(cfg.head_dim // 2, 1)),
                                 dtype=torch.float32, device=x.device)
        y = pipe(params["runs"][0], x, angles)
        y = rmsnorm(y, tp.top("final_norm"), cfg.norm_eps, backend=backend)
        return tp.gather_vocab(tr._lm_logits(params, cfg, y[:, -1], tp))

    step.route = ROUTE
    return step
