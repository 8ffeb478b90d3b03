"""Optimizers as functional updates on trees of tensors (the JAX package's
``optim/optimizers.py``): ``update(grads, state, params)`` returns new
parameters and a new state and changes neither argument, with the
reference's arithmetic in the reference's order, so one step can be held
to it. ``torch.optim`` is not used: its SGD and AdamW order the weight
decay and momentum differently and have no global-norm clip.

``sgd_momentum`` is the paper's fine-tuning optimizer (§4.1: momentum 0.9).
``adamw`` drives the reduced-scale runs; its moments may be held in a
narrower dtype (``moment_dtype``), and it walks a large leaf in slabs
(``slabwise``) so that its float32 temporaries stay the size of a slab.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    #: (grads, state, params) -> (params, state); AdamW also takes
    #: ``sq_norm``, the function that gives its clip the squared global
    #: norm of ``grads`` (``global_sq_norm`` unless a sharded step passes
    #: one that sums over every rank's shard)
    update: Callable[..., Any]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples
    (every tree in ``rest`` has ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


#: the most entries of one slab of ``slabwise``: 2**26, 256 MB of float32
SLAB = 1 << 26


def slabwise(fn: Callable, dtype: torch.dtype,
             *tensors: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``dtype`` and ``tensors[0]``'s shape, filled by an
    elementwise ``fn(*tensors, out=...)`` whose last operation writes its
    float32 result into ``out`` (which takes the cast), called on slabs of
    the tensors' first dim of at most ``SLAB`` entries each: the same bits
    as one call, with temporaries the size of a slab (whole, those of a
    stacked leaf such as Mamba2-2.7B's ``w_in``, 1.73 B entries, took ~40
    GB of the card), and no copy a slab. A tensor of at most ``SLAB``
    entries, or a 0-d one, is one call."""
    t = tensors[0]
    out = torch.empty(t.shape, dtype=dtype, device=t.device)
    if t.dim() == 0 or t.numel() <= SLAB:
        fn(*tensors, out=out)
        return out
    rows = max(1, SLAB // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        fn(*(x[i:i + rows] for x in tensors), out=out[i:i + rows])
    return out


def value_and_grad(loss_fn: Callable, tree) -> Tuple[torch.Tensor, Any]:
    """``loss_fn(tree)`` and its gradient with respect to every leaf of
    ``tree``, as a tree of the same structure (autograd on a detached
    copy of the leaves; ``tree`` is left unchanged). A leaf the loss does
    not read (an audio encoder's token embedding) gets zeros, as JAX's
    gradient gives it."""
    with torch.enable_grad():
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), tree)
        loss = loss_fn(leaves)
        flat = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                        allow_unused=True,
                                        materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(flat), tree)


def global_sq_norm(grads) -> torch.Tensor:
    """The squared L2 norm of a whole gradient tree, in float32: each
    leaf's sum of squares, summed in the tree's order."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in tree_leaves(grads))


def _zeros_like(params, dtype=None):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)


def sgd_momentum(schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum; it has no clip, so ``update`` ignores the
    ``sq_norm`` a sharded step passes every optimizer."""
    def init(params):
        return {"mom": _zeros_like(params, torch.float32), "step": 0}

    @torch.no_grad()
    def update(grads, state, params, sq_norm=None):
        lr = schedule(state["step"])
        mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                       state["mom"], grads)
        new_params = tree_map(
            lambda p, m: (p.to(torch.float32)
                          - lr * (m + weight_decay * p.to(torch.float32))
                          ).to(p.dtype),
            params, mom)
        return new_params, {"mom": mom, "step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=torch.float32,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params, moment_dtype),
                "v": _zeros_like(params, moment_dtype), "step": 0}

    @torch.no_grad()
    def update(grads, state, params, sq_norm=global_sq_norm):
        step = state["step"] + 1
        lr = schedule(state["step"])
        if grad_clip:
            gnorm = torch.sqrt(sq_norm(grads))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        f32 = torch.float32

        def first(mm, g, out):
            return torch.add(b1 * mm.to(f32), (1 - b1) * g.to(f32), out=out)

        def second(vv, g, out):
            return torch.add(b2 * vv.to(f32),
                             (1 - b2) * torch.square(g.to(f32)), out=out)
        m = tree_map(lambda mm, g: slabwise(first, moment_dtype, mm, g),
                     state["m"], grads)
        v = tree_map(lambda vv, g: slabwise(second, moment_dtype, vv, g),
                     state["v"], grads)
        t = torch.tensor(step, dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd(p, mm, vv, out):
            mhat = mm.to(torch.float32) / bc1
            vhat = vv.to(torch.float32) / bc2
            delta = (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.to(torch.float32))
            return torch.sub(p.to(torch.float32), lr * delta, out=out)

        new_params = tree_map(
            lambda p, mm, vv: slabwise(upd, p.dtype, p, mm, vv), params, m, v)
        return new_params, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def make_optimizer(name: str, schedule, **kw) -> Optimizer:
    if name == "sgd":
        return sgd_momentum(schedule, **kw)
    if name == "adamw":
        return adamw(schedule, **kw)
    raise ValueError(name)
