"""Step functions the launchers serve through (the reference's
``launch/steps.py``, serving half): prefill and decode. The training step
comes with the training slice.

Each step runs on one device, the card unless the caller passes
``device="cpu"`` (``device.resolve_device``): the step moves its batch
there (tokens as int64, an audio config's ``embeds`` and a VLM config's
``vision_embeds`` in the model's dtype, ``mrope_positions`` as int32), and
the parameters and cache must already live there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import check_head_dim
from repro_torch.models import transformer as tr


def _on(device: torch.device, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(device=device, dtype=torch.long)


def batch_on(device: torch.device, cfg: ModelConfig, batch):
    """``batch`` with each of its inputs on ``device`` in the type the
    stack reads it in."""
    dtype = getattr(torch, cfg.dtype)
    types = {"tokens": torch.long, "embeds": dtype, "vision_embeds": dtype,
             "mrope_positions": torch.int32}
    return {name: (torch.as_tensor(t).to(device=device, dtype=types[name])
                   if name in types else t) for name, t in batch.items()}


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
    if dev.type == "cuda" and cfg.num_heads and cfg.attention == "gqa":
        check_head_dim(cfg.head_dim)

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
