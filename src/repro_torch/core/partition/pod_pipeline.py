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
stage on its current activation, then the activation (and its rotary
angles) shifts one pod to the right. Ticks = microbatches + pods - 1
(fill and drain; every pod computes every tick, as the reference's scan
does). The last pod's result is all-reduced over "pod" in float32 with
zeros from the others, the reference's ``psum``: every pod gets its bits.

What differs from the reference: inside a stage the reference shards the
microbatch activation over ("data", "model"), so its hop moves 1/256th of
the activation a chip. The port's stage computes on whole local tensors
(its kernels take plain tensors), as its serve steps do: each rank gathers
its pod's stage weights whole over "data" and "model" and computes the
whole microbatch, and each rank's hop sends the whole microbatch.

Scope, as the reference's: architectures whose layer stack is a single
homogeneous run (dense GQA, pure MoE, pure SSM; zamba2's shared-block
hybrid and deepseek's dense-then-MoE stack are not) and num_layers %
n_pods == 0.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import _check_card, batch_on
from repro_torch.models import transformer as tr
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.optim.optimizers import tree_map
from repro_torch.sharding import specs as sh


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


def _stage_apply(cfg: ModelConfig, stage_params, x: torch.Tensor,
                 angles: torch.Tensor, backend: str) -> torch.Tensor:
    """This pod's layer range over x (one microbatch), layer by layer."""
    kind = tr.layer_runs(cfg)[0].kind
    count = next(tr._leaves(stage_params)).shape[0]
    for j in range(count):
        lp = tr._index(stage_params, j)
        if kind == "ssm":
            x, _ = tr._ssm_block(cfg, lp, x, None, backend, False)
        else:
            x, _, _ = tr._attn_block(cfg, lp, x, angles, None, backend)
    return x


def _full(t):
    """A DTensor gathered whole; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _my_stage(leaf, mesh, pod: int):
    """This rank's stage of a stacked (n_pods, L/P, ...) leaf: of a
    DTensor, its "pod" shard gathered whole over the other dims; of a
    plain tensor, entry ``pod``."""
    if not hasattr(leaf, "redistribute"):
        return leaf[pod]
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(0) if n == "pod" else Replicate()
               for n in mesh.mesh_dim_names)
    return leaf.redistribute(mesh, pl).to_local()[0]


def _hop(tensors: List[torch.Tensor], pod: int, n_pods: int, peers,
         group) -> List[torch.Tensor]:
    """Send ``tensors`` one pod right and receive the left pod's: what
    this pod runs next tick (pod 0 receives nothing: zeros)."""
    import torch.distributed as dist
    nxt, prev = peers
    got = [torch.empty_like(t) for t in tensors]
    ops = []
    if pod < n_pods - 1:
        ops += [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
                for t in tensors]
    if pod > 0:
        ops += [dist.P2POp(dist.irecv, g, prev, group) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got if pod > 0 else [torch.zeros_like(t) for t in tensors]


def make_pipeline_forward(cfg: ModelConfig, n_pods: int,
                          num_microbatches: int, mesh,
                          backend: str = "auto"):
    """-> ``fn(stage_params, x, angles) -> y``: x (B, S, d_model) hidden
    states (the embedding and the head run outside), y (B, S, d_model)
    after all L layers, the same on every pod. ``stage_params`` leaves are
    (n_pods, L/P, ...) (``stack_stage_params``): DTensors sharded over
    "pod", or plain tensors. B % num_microbatches == 0."""
    import torch.distributed as dist
    if dict(zip(mesh.mesh_dim_names, mesh.shape)).get("pod") != n_pods:
        raise ValueError(f"the mesh's pod axis is not {n_pods} wide: "
                         f"{mesh}")
    M = num_microbatches

    def pipelined(stage_params, x, angles):
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        pod = coord["pod"]
        local = tree_map(lambda a: _my_stage(a, mesh, pod), stage_params)
        B = x.shape[0]
        if B % M:
            raise ValueError(f"{M} microbatches do not divide batch {B}")
        mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
        # angles ride along with their microbatch (per-row M-RoPE safe)
        amb = angles.reshape((M, B // M) + tuple(angles.shape[1:]))
        group, peers = None, (None, None)
        if n_pods > 1:
            # this rank's ("data", "model") coordinate in every pod, pod
            # by pod
            group = mesh.get_group("pod")
            ranks = dist.get_process_group_ranks(group)
            peers = (ranks[min(pod + 1, n_pods - 1)], ranks[max(pod - 1, 0)])
        state, state_a = torch.zeros_like(mb[0]), torch.zeros_like(amb[0])
        outs = torch.zeros_like(mb)
        for t in range(M + n_pods - 1):
            if pod == 0:
                x_in = mb[min(t, M - 1)] if t < M else torch.zeros_like(mb[0])
                a_in = (amb[min(t, M - 1)] if t < M
                        else torch.zeros_like(amb[0]))
            else:
                x_in, a_in = state, state_a
            h = _stage_apply(cfg, local, x_in, a_in, backend)
            if n_pods > 1:
                # shift one pod to the right (the paper's T_TX hop)
                state, state_a = _hop([h, a_in], pod, n_pods, peers, group)
            # the LAST pod emits microbatch t-(P-1) at tick t
            out_idx = t - (n_pods - 1)
            if pod == n_pods - 1 and out_idx >= 0:
                outs[out_idx] = h
        y = outs.reshape(x.shape)
        if n_pods == 1:
            return y
        # the last pod's result on every pod: a float32 sum with zeros
        # from the others (the reference's psum), which keeps its bits
        y32 = (y.to(torch.float32) if pod == n_pods - 1
               else torch.zeros(y.shape, dtype=torch.float32,
                                device=y.device))
        dist.all_reduce(y32, group=group)
        return y32.to(x.dtype)

    return pipelined


def make_split_serve_step(cfg: ModelConfig, n_pods: int,
                          num_microbatches: int, mesh,
                          device: DeviceLike = None, backend: str = "auto"):
    """-> ``step(params, batch) -> last-position logits (B, V)``: embed,
    the pod-pipelined stack, the final norm, the head, on the card unless
    the caller passes ``device="cpu"``. ``params`` as from ``init_params``
    but with ``params["runs"][0]`` restacked by ``stack_stage_params``
    (leading (n_pods, L/P) dims); its other leaves DTensors (gathered
    whole) or plain tensors."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the step on "
                         f"{dev.type}")
    pipe = make_pipeline_forward(cfg, n_pods, num_microbatches, mesh,
                                 backend)

    def step(params, batch):
        whole = {k: tree_map(_full, v) for k, v in params.items()
                 if k != "runs"}
        batch = batch_on(dev, cfg, batch)
        x, B, S = tr.embed_inputs(whole, cfg, batch)
        angles = tr._angles_for(cfg, batch, B, S, 0, x.device)
        if angles is None:
            angles = torch.zeros((B, S, max(cfg.head_dim // 2, 1)),
                                 dtype=torch.float32, device=x.device)
        y = pipe(params["runs"][0], x, angles)
        y = rmsnorm(y, whole["final_norm"], cfg.norm_eps, backend=backend)
        return tr._lm_logits(whole, cfg, y[:, -1])

    return step
