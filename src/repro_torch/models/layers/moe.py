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

Expert weights are stacked (E, ...), as in the reference. Its sharding
constraints on the dispatch buffer and the expert outputs (expert
parallelism on the "model" mesh axis) and on the gathered output (the
data axes) are kept (``sharding.constraints.maybe_constrain``); outside a
mesh, and on the plain tensors the sharded train step runs the model on,
each is the identity.

Pruning hook: ``expert_mask`` (E,) — pruned experts get a router logit of
-1e30, so the softmax or sigmoid gives them a score of 0 and top-k never
picks one while at least ``top_k`` experts are kept.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.models.layers.init import normal, slot
from repro_torch.models.layers.mlp import GATED, _act
from repro_torch.sharding.constraints import data_axes_spec, maybe_constrain
from repro_torch.sharding.specs import P


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
    logits = x2d.to(torch.float32) @ params["w_router"]
    if expert_mask is not None:
        logits = torch.where(expert_mask[None] > 0, logits, -1e30)
    if moe.score_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    probs, idx = torch.topk(scores, moe.top_k, dim=-1)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    E = moe.num_experts
    dense_probs = torch.softmax(logits, dim=-1)
    frac = torch.nn.functional.one_hot(idx, E).to(torch.float32).sum(1) \
        .mean(0)
    aux = E * torch.sum(frac * dense_probs.mean(0)) * moe.router_aux_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * moe.router_z_weight
    return probs, idx, aux, z


def moe_forward(params, moe, x: torch.Tensor, activation: str, *,
                expert_mask: Optional[torch.Tensor] = None):
    """x (B, S, d) -> (out (B, S, d), MoEMetrics)."""
    B, S, d = x.shape
    T = B * S
    dev = x.device
    x2d = x.reshape(T, d)
    probs, idx, aux, z = route(params, moe, x2d, expert_mask)
    E, k = moe.num_experts, moe.top_k
    C = capacity(T, moe)

    flat_e = idx.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_p = probs.reshape(-1)
    # stable, as jnp.argsort is: the position within an expert, and with
    # it which assignments fall past C, follows token order
    order = torch.argsort(flat_e, stable=True)
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    # bincount's output length depends on the data; a count of static
    # shape gives the same integers
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)             # E*C = drop bin
    keep_x = keep[:, None].to(x.dtype)

    dspec = data_axes_spec()
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = x2d[st] * keep_x
    eb = buf[:-1].reshape(E, C, d)
    # expert parallelism: the dispatch buffer lives expert-sharded on
    # "model"
    eb = maybe_constrain(eb, P("model", None, None))
    h = _act(torch.bmm(eb, params["w_up"]), activation)
    if activation in GATED:
        h = h * torch.bmm(eb, params["w_gate"])
    h = maybe_constrain(h, P("model", None, None))
    ob = torch.bmm(h, params["w_down"])
    ob = maybe_constrain(ob, P("model", None, None)).reshape(E * C, d)

    gathered = ob[slot.clamp(max=E * C - 1)] * keep_x
    out = torch.zeros((T, d), dtype=torch.float32, device=dev).index_add_(
        0, st, gathered.to(torch.float32) * sp[:, None])
    out = maybe_constrain(out, P(dspec, None)).to(x.dtype)

    if moe.num_shared:
        hs = _act(x2d @ params["w_up_sh"], activation)
        if activation in GATED:
            hs = hs * (x2d @ params["w_gate_sh"])
        out = out + hs @ params["w_down_sh"]

    drop = 1.0 - keep.sum().to(torch.float32) / (T * k)
    return out.reshape(B, S, d), MoEMetrics(aux, z, drop)
