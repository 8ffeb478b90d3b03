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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import check_head_dim
from repro_torch.models import transformer as tr
from repro_torch.optim.optimizers import (Optimizer, tree_map,
                                          value_and_grad)


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
                   backend: str = "auto"):
    """(metrics, grads): ``loss_fn``'s metrics, detached, and its gradient
    with respect to every leaf of ``params`` (``optim.value_and_grad``),
    on the device the parameters and ``batch`` already live on; the
    kernel path (``backend="auto"``) or the plain versions (``"ref"``)."""
    out = {}

    def loss(p):
        total, out["metrics"] = tr.loss_fn(p, cfg, batch, masks, backend)
        return total
    _, grads = value_and_grad(loss, params)
    return {k: v.detach() for k, v in out["metrics"].items()}, grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, masks=None,
                    grad_accum: int = 1, device: DeviceLike = None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (``optim.value_and_grad`` of
    ``loss_fn``), then ``optimizer.update``, as the reference's step.
    ``batch`` holds ``labels`` (B, S) beside the inputs ``prefill`` takes.
    ``grad_accum > 1`` runs the batch as that many microbatches
    (``_microbatches``), sums their gradients in fp32, divides by
    ``grad_accum`` and casts each to its parameter's dtype, and averages
    the metrics: live activations shrink by the factor."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)

    def train_step(params, opt_state, batch):
        batch = batch_on(dev, cfg, batch)
        if grad_accum == 1:
            metrics, grads = loss_and_grads(params, cfg, batch, masks)
        else:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for mb in _microbatches(batch, grad_accum):
                m, g = loss_and_grads(params, cfg, mb, masks)
                gsum = tree_map(lambda acc, gg: acc + gg.to(torch.float32),
                                gsum, g)
                del g
                ms.append(m)
            grads = tree_map(lambda g, p: (g / grad_accum).to(p.dtype),
                             gsum, params)
            del gsum
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None,
                      masks=None, device: DeviceLike = None):
    """-> ``prefill_step(params, batch) -> (last_logits (B,V), cache)``.
    On the card a config whose attention goes through the flash kernel
    (GQA) but whose head dim the kernel has no instance of is refused
    here, not in its first attention layer; MLA's attention never reaches
    that kernel. ``batch`` holds ``tokens`` (B, S), or an audio config's
    ``embeds`` (B, S, d_model); a VLM config's also ``vision_embeds`` (B,
    V, d_model) and, optionally, ``mrope_positions`` (3, B, V + S). A
    bidirectional config returns (all logits (B, S, V), None)."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    _check_card(cfg, dev)

    def prefill_step(params, batch):
        batch = batch_on(dev, cfg, batch)
        return tr.prefill(params, cfg, batch, max_len=max_len, masks=masks)
    return prefill_step


def make_decode_step(cfg: ModelConfig, masks=None,
                     device: DeviceLike = None):
    """-> ``decode_step(params, cache, tokens (B,1)) -> (logits (B,V),
    cache)``; the cache's tensors (KV or MLA latent slots, SSD states and
    conv windows) are updated in place. A bidirectional (encoder-only)
    config has no decode step and is refused."""
    tr.check_supported(cfg)
    if not cfg.causal:
        raise ValueError(f"{cfg.name}: a bidirectional encoder has no "
                         f"decode step; its prefill returns every "
                         f"position's logits")
    dev = resolve_device(device)

    def decode_step(params, cache, tokens):
        return tr.decode_step(params, cfg, cache, _on(dev, tokens),
                              masks=masks)
    return decode_step
