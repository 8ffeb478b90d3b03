"""Plain PyTorch versions of the fused RMSNorm's two entries: the CPU
path, and the yardstick the CUDA kernel is held against on the card.
``rmsnorm_ref`` is the reference's ``kernels/rmsnorm/ref.py``;
``gated_rmsnorm_ref`` the reference's ``models/layers/norms.py``
``gated_rmsnorm`` (Mamba2's norm-then-gate)."""
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
    x32 = x.to(acc)
    z32 = z.to(acc)
    g = x32 * (z32 * torch.where(z32 >= 0, 1 / (1 + torch.exp(-z32)),
                                 torch.exp(z32) / (1 + torch.exp(z32))))
    var = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return ((g / torch.sqrt(var + eps))
            * scale.to(acc)).to(x.dtype)
