"""Plain PyTorch versions of the fused RMSNorm's entries: the CPU path,
and the yardstick the CUDA kernel is held against on the card.
``rmsnorm_ref`` is the reference's ``kernels/rmsnorm/ref.py``;
``gated_rmsnorm_ref`` the reference's ``models/layers/norms.py``
``gated_rmsnorm`` (Mamba2's norm-then-gate); ``gated_sumsq_ref`` and
``gated_rmsnorm_stat_ref`` its two halves where the row is split over
ranks: each rank's sum of squares, then the normalization by the whole
row's."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                scale_offset: float = 0.0) -> torch.Tensor:
    """x (..., d), scale (d,). fp32 math (float64 for float64 operands,
    which gradient checks use), cast back to x's dtype.

    ``scale_offset=1.0`` gives the gemma convention (weights stored as
    ``scale - 1``)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * (scale.to(acc) + scale_offset)).to(x.dtype)


def gated_rmsnorm_ref(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's norm-then-gate: RMSNorm(x * silu(z)) * scale, in fp32
    (float64 for float64 operands) with the stable sigmoid, cast back to
    x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = _gate(x, z)
    var = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return ((g / torch.sqrt(var + eps))
            * scale.to(acc)).to(x.dtype)


def _gate(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = x * silu(z) in fp32 (float64 for float64 operands), the sigmoid
    in its stable form."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    z32 = z.to(acc)
    return x32 * (z32 * torch.where(z32 >= 0, 1 / (1 + torch.exp(-z32)),
                                    torch.exp(z32) / (1 + torch.exp(z32))))


def gated_sumsq_ref(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x, z (..., d) -> (...,): each row's sum of g² (g = x * silu(z)) in
    fp32 (float64 for float64 operands)."""
    return torch.sum(torch.square(_gate(x, z)), dim=-1)


def gated_rmsnorm_stat_ref(x: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, sumsq: torch.Tensor,
                           width: int, eps: float = 1e-6) -> torch.Tensor:
    """``gated_rmsnorm_ref`` of d columns of rows ``width`` wide, given
    each whole row's sum of g² (``sumsq`` (...,), fp32): g / sqrt(sumsq /
    width + eps) * scale, cast back to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = _gate(x, z)
    var = sumsq.to(acc)[..., None] / width
    return ((g / torch.sqrt(var + eps)) * scale.to(acc)).to(x.dtype)
