"""Normalization layers.

``rmsnorm`` (every pre-norm of the stack) and ``gated_rmsnorm`` (the
Mamba2 block's norm-then-gate) go through the kernel wrappers
(``kernels.rmsnorm.ops``), which launch the CUDA kernel for a tensor on
the card and run the plain version for one on the CPU. ``backend="ref"``
runs the plain versions on the card too: the yardstick that the kernel
path is held against there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ops import gated_rmsnorm as _gated_kernel
from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ops import \
    split_gated_rmsnorm as _split_kernel
from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_ref, rmsnorm_ref

__all__ = ["rmsnorm_ref", "gated_rmsnorm_ref", "rmsnorm", "layernorm",
           "gated_rmsnorm", "split_gated_rmsnorm"]


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
                  eps: float = 1e-6, backend: str = "auto") -> torch.Tensor:
    """Mamba2's norm-then-gate, RMSNorm(x * silu(z)) * scale: the kernel's
    gated entry (``"auto"``) or the plain version (``"ref"``)."""
    if backend == "ref":
        return gated_rmsnorm_ref(x, z, scale, eps)
    return _gated_kernel(x, z, scale, eps)


def split_gated_rmsnorm(x: torch.Tensor, z: torch.Tensor,
                        scale: torch.Tensor, eps: float, axis, width: int,
                        backend: str = "auto") -> torch.Tensor:
    """The gated norm of this rank's columns of rows ``width`` wide split
    over ``axis`` (``kernels.rmsnorm.ops.split_gated_rmsnorm``): the
    kernel's two split entries (``"auto"``) or their plain versions
    (``"ref"``), the row sums of squares all-reduced between them."""
    return _split_kernel(x, z, scale, eps, axis, width,
                         plain=backend == "ref")
