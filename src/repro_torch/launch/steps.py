"""Step functions the launchers serve through (the reference's
``launch/steps.py``, serving half): prefill and decode. The training step
comes with the training slice.

Each step runs on one device, the card unless the caller passes
``device="cpu"`` (``device.resolve_device``): the step moves its token
batch there, and the parameters and cache must already live there.
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


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None,
                      masks=None, device: DeviceLike = None):
    """-> ``prefill_step(params, batch) -> (last_logits (B,V), cache)``.
    On the card a config whose attention head dim the flash kernel has no
    instance of is refused here, not in its first attention layer."""
    tr.check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.num_heads:
        check_head_dim(cfg.head_dim)

    def prefill_step(params, batch):
        batch = dict(batch, tokens=_on(dev, batch["tokens"]))
        return tr.prefill(params, cfg, batch, max_len=max_len, masks=masks)
    return prefill_step


def make_decode_step(cfg: ModelConfig, masks=None,
                     device: DeviceLike = None):
    """-> ``decode_step(params, cache, tokens (B,1)) -> (logits (B,V),
    cache)``; the cache's tensors (KV slots, SSD states and conv windows)
    are updated in place."""
    tr.check_supported(cfg)
    dev = resolve_device(device)

    def decode_step(params, cache, tokens):
        return tr.decode_step(params, cfg, cache, _on(dev, tokens),
                              masks=masks)
    return decode_step
