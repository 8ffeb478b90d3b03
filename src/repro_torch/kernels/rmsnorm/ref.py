"""Plain PyTorch version of the fused RMSNorm (the reference's
``kernels/rmsnorm/ref.py``): the CPU path, and the yardstick the CUDA
kernel is held against on the card."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                scale_offset: float = 0.0) -> torch.Tensor:
    """x (..., d), scale (d,). fp32 math, cast back to x's dtype.

    ``scale_offset=1.0`` gives the gemma convention (weights stored as
    ``scale - 1``)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * (scale.to(torch.float32) + scale_offset)).to(x.dtype)
