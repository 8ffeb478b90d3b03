"""Rotary position embeddings (standard RoPE). M-RoPE (Qwen2-VL) comes
with the VLM configs."""
from __future__ import annotations

from typing import Union

import torch


def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (B, S, D//2) -> rotated x (same dtype)."""
    half = x.shape[-1] // 2
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    cos = torch.cos(angles)[..., None, :]   # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(batch: int, seq: int, offset=0,
                  device: Union[str, torch.device, None] = None
                  ) -> torch.Tensor:
    """(1 or B, S) int32 positions ``offset + 0..S-1``; ``offset`` is a
    scalar or a (B,) tensor."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    return (torch.arange(seq, dtype=torch.int32, device=off.device)[None, :]
            + off.reshape(-1, 1))
