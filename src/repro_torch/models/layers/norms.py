"""Normalization layers.

``rmsnorm`` is the one the transformer stack calls: it goes through the
kernel wrapper (``kernels.rmsnorm.ops``), which launches the CUDA kernel
for a tensor on the card and runs the plain version for one on the CPU.
``backend="ref"`` runs the plain version on the card too: the yardstick
that the kernel path is held against there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm_ref", "rmsnorm", "layernorm", "gated_rmsnorm"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            scale_offset: float = 0.0, backend: str = "auto") -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype: the kernel (``"auto"``) or
    the plain version (``"ref"``)."""
    if backend == "ref":
        return rmsnorm_ref(x, scale, eps, scale_offset)
    return _rmsnorm_kernel(x, scale, eps=eps, scale_offset=scale_offset)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) / torch.sqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's norm-then-gate: RMSNorm(x * silu(z))."""
    x32 = x.to(torch.float32)
    z32 = z.to(torch.float32)
    g = x32 * (z32 * torch.where(z32 >= 0, 1 / (1 + torch.exp(-z32)),
                                 torch.exp(z32) / (1 + torch.exp(z32))))
    var = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return ((g / torch.sqrt(var + eps))
            * scale.to(torch.float32)).to(x.dtype)
