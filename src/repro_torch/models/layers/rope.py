"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE [arXiv:2409.12191] splits the head_dim/2 frequency bands into
(temporal, height, width) sections; text tokens use identical t/h/w
position ids, vision tokens their 3-D grid coordinates.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import torch
from torch._guards import detect_fake_mode


def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies. The float32 power is taken in
    float64 and rounded once: the reference's float32 power is correctly
    rounded, and PyTorch's is not everywhere (one unit in the last place
    off at head_dim 128, band 37)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps.to(torch.float64)).to(torch.float32)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """positions (3, B, S) with (t, h, w) ids -> angles (B, S, head_dim//2).

    ``sections`` gives how many frequency bands each of t/h/w owns;
    sum(sections) == head_dim // 2. Each axis's angles are computed as
    ``rope_angles`` computes them, then each band takes its section's
    axis by a gather (the reference's one-hot float32 einsum adds exact
    zeros to the same products: the same bits, and no matrix product
    that TF32 could round on the card)."""
    if positions.shape[0] != 3:
        raise ValueError(f"mrope positions {tuple(positions.shape)}: the "
                         f"leading axis holds (t, h, w)")
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    ang = rope_angles(positions, head_dim, theta)       # (3, B, S, half)
    return _select_sections(ang, _section_ids(tuple(sections),
                                              positions.device))


def _section_ids(sections: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """(half,) axis of each band: a constant of the config, not of the
    step, built from the Python tuple and kept once a device. Under a fake
    mode (a traced dry run) it is built anew and never kept: a fake tensor
    cached under the device's key would be handed to every later real
    run."""
    if detect_fake_mode() is not None:
        return _ids_tensor(sections, device)
    return _cached_ids(sections, device)


def _ids_tensor(sections: Tuple[int, ...],
                device: torch.device) -> torch.Tensor:
    ids = [axis for axis, n in enumerate(sections) for _ in range(n)]
    return torch.tensor(ids, dtype=torch.long).to(device)


_cached_ids = functools.lru_cache(maxsize=None)(_ids_tensor)


def _select_sections(ang: torch.Tensor, sec_id: torch.Tensor) -> torch.Tensor:
    """ang (3, B, S, half), sec_id (half,) in {0,1,2} -> (B, S, half):
    band h from axis sec_id[h]."""
    idx = sec_id.view(1, 1, 1, -1).expand(1, *ang.shape[1:])
    return ang.gather(0, idx)[0]


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


def text_mrope_positions(batch: int, seq: int, offset=0,
                         device: Union[str, torch.device, None] = None
                         ) -> torch.Tensor:
    """Text-only M-RoPE ids: t == h == w == position. (3, B, S) int32."""
    p = positions_for(batch, seq, offset, device).expand(batch, seq)
    return p[None].expand(3, batch, seq)
