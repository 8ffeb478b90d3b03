"""The mesh cases and step runners that ``test_torch_tensor_parallel.py``
(the rows split over "data", and "model") and
``test_torch_tensor_parallel_data.py`` (the sequence split and
microbatches over "data") share: the configs, the numpy inputs both
packages take, the train steps through ``make_train_step`` and the checks
against the one-process steps. No JAX at module level: the spawned gloo
ranks import it by name; the reference's parts import JAX when called."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config

#: (name, registry arch, config overrides, masked); ``moe`` overrides
#: fields of the config's ``MoEConfig``
CASES = (("qwen2-7b", "qwen2-7b", {}, True),
         ("qwen2-vl-7b", "qwen2-vl-7b", {}, False),
         ("gemma-7b", "gemma-7b", {}, False),
         ("nemotron-4-340b", "nemotron-4-340b", {}, False),
         ("hubert-xlarge", "hubert-xlarge", {}, False),
         ("gqa-10-over-2", "qwen2-7b",
          dict(num_heads=10, num_kv_heads=2, head_dim=32), True),
         ("mixtral-8x7b", "mixtral-8x7b", {}, False),
         ("deepseek-v3-671b", "deepseek-v3-671b", {}, True),
         ("mixtral-2-experts", "mixtral-8x7b",
          dict(moe=dict(num_experts=2, top_k=1, capacity_factor=0.5)),
          False),
         ("mamba2-2.7b", "mamba2-2.7b", {}, True),
         ("zamba2-1.2b", "zamba2-1.2b", {}, False),
         ("mamba2-10-heads-2-groups", "mamba2-2.7b",
          dict(d_model=160, ssm=dict(n_groups=2)), True))

#: the case whose whole-batch capacity binds where the per-rank one
#: would not (the fault of a dispatch per data rank)
FAULT_CASE = "mixtral-2-experts"
B, S, DECODE = 2, 8, 4
LR = 1e-3
#: AdamW's eps near the gradients' size (as ``tests/test_torch_mesh.py``):
#: an update moves with the gradient, not with the sign of an entry near 0
EPS = 1e-3
METRIC_RTOL = 1e-6
PARAM_ULPS = 4
UPDATE_RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def case(name):
    return next(c for c in CASES if c[0] == name)


def configured(cfg, over):
    """``cfg`` in float32 with the case's overrides (``moe`` and ``ssm``:
    fields of its ``MoEConfig`` or ``SSMConfig``), for either package's
    config."""
    over = dict(over)
    for sub in ("moe", "ssm"):
        if over.get(sub):
            over[sub] = dataclasses.replace(getattr(cfg, sub), **over[sub])
    return cfg.replace(dtype="float32", **over)


def port_config(name):
    _, arch, over, _ = case(name)
    return configured(get_smoke_config(arch), over)


def leaves(tree):
    from repro_torch.optim.optimizers import tree_leaves
    return tree_leaves(tree)


def whole(t):
    """A copy of ``t`` whole: a DTensor gathered (a replicated one's
    ``full_tensor`` is its local tensor, which a decode step then writes
    in place)."""
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def train_steps(cfg, params, masks, batch, mesh=None, steps: int = 2,
                grad_accum: int = 1) -> dict:
    """``steps`` AdamW steps of ``batch`` in ``grad_accum`` microbatches
    through ``make_train_step`` (on ``mesh``, or in one process): its
    route, each step's metrics, the first step's gradient and the
    parameters after, every tensor whole."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.optim.schedules import constant
    from repro_torch.sharding import specs as sh
    opt = adamw(constant(LR), eps=EPS)
    seen = []

    def update(grads, state, p, **kw):
        seen.append(grads)
        return opt.update(grads, state, p, **kw)
    state = opt.init(params)
    p = params
    if mesh is not None:
        ps = sh.param_specs(params, cfg, mesh)
        p = sh.distribute(params, ps, mesh)
        state = sh.distribute(state, sh.opt_state_specs(state, ps), mesh)
    step = make_train_step(cfg, Optimizer(opt.init, update), masks,
                           grad_accum=grad_accum, device="cpu", mesh=mesh)
    out = {"route": getattr(step, "route", None), "metrics": []}
    for i in range(steps):
        p, state, m = step(p, state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            g = leaves(seen[0])
            if mesh is not None:
                g = [DTensor.from_local(t, mesh, q.placements,
                                        run_check=False, shape=q.shape,
                                        stride=q.stride())
                     for t, q in zip(g, leaves(p))]
            out["grads"] = [whole(t) for t in g]
    out["params"] = [whole(t) for t in leaves(p)]
    return out


def close(got, want, tol_of):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol_of(want)


def stack_tol32(want):
    from torch_parity import stack_tol
    return stack_tol(want, "float32")


def hold_to_one_process(got, want) -> None:
    """A mesh's train steps (``train``) against the one-process steps':
    each step's metrics within ``METRIC_RTOL``, the parameters after them
    within ``PARAM_ULPS`` of a leaf's largest entry plus ``UPDATE_RTOL``
    of one step's lr."""
    assert len(got["metrics"]) == len(want["metrics"])
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert set(gm) == set(wm)
        for k, v in wm.items():
            assert abs(gm[k] - v) <= METRIC_RTOL * max(abs(v), 1.0)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        tol = PARAM_ULPS * EPS32 * float(w.abs().max()) + UPDATE_RTOL * LR
        close(g, w, lambda _: tol)


def reference_cache_leaves(cr, cache):
    """The reference's cache leaves of its runs, as numpy, stacked as the
    port's are: a hybrid's ssm run, ((groups, period, ...), tail), flat
    over its layers."""
    import jax
    from torch_parity import to_f32
    if not cr.shared_attn_period:
        return [to_f32(c) for c in jax.tree_util.tree_leaves(cache["runs"])]
    out = []
    for rc in cache["runs"]:
        parts = [p for p in rc if p is not None]
        for f, nd in (("conv", 3), ("state", 4)):
            out.append(np.concatenate(
                [to_f32(getattr(p, f)).reshape(
                    (-1,) + getattr(p, f).shape[-nd:]) for p in parts]))
    return out


def case_inputs(name: str):
    """((cr, pn, mn, bn, tok): the reference's config and the numpy
    parameters, masks (ratio 0.5 where the case asks), batch of ``B`` x
    ``S`` and ``DECODE`` decode tokens; the port's ``params``, ``masks``,
    ``batch`` and ``tokens`` of the same arrays), made from seeds."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as rreg
    from repro.core.pruning import masks as rmasks
    from repro_torch.interop import (transformer_masks_from_reference,
                                     transformer_params_from_reference)
    from torch_parity import train_batch_np, transformer_params_np
    _, arch, over, masked = case(name)
    cr = configured(rreg.get_smoke_config(arch), over)
    pn = transformer_params_np(cr, seed=3)
    mn = None
    if masked:
        n = len(rmasks.transformer_prunable_units(cr))
        mn = jax.tree_util.tree_map(
            np.asarray, rmasks.transformer_masks_from_ratios(
                jax.tree_util.tree_map(jnp.asarray, pn), cr, [0.5] * n))
    bn = train_batch_np(cr, B, S, seed=5)
    tok = np.random.default_rng(6).integers(
        0, cr.vocab_size, (DECODE, B, 1)).astype(np.int32)
    inp = {"params": transformer_params_from_reference(pn),
           "masks": transformer_masks_from_reference(mn),
           "batch": {k: torch.from_numpy(np.asarray(v))
                     for k, v in bn.items()},
           "tokens": [torch.from_numpy(t.astype(np.int64)) for t in tok]}
    return (cr, pn, mn, bn, tok), inp
