"""Wrapper of the fused RMSNorm: ``x (..., d)`` normalised row by row.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/rmsnorm.cu``) on the current stream, or raises; on a CPU tensor it
runs the plain version (``ref.rmsnorm_ref``). There is no fallback from
one to the other. ``rmsnorm.launches`` counts kernel launches. Unlike the
reference's wrapper it pads nothing: the kernel runs one block per row.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_ENTRIES = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            scale_offset: float = 0.0) -> torch.Tensor:
    """x (..., d), scale (d,) -> (..., d) in x's dtype; fp32 math."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, scale_offset)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    if x.dtype not in _ENTRIES:
        raise TypeError(f"rmsnorm: the CUDA kernel takes float32 or "
                        f"bfloat16, x is {x.dtype}")
    if scale.dtype != x.dtype or scale.device != x.device:
        raise TypeError(f"rmsnorm: scale is {scale.dtype} on "
                        f"{scale.device}, x is {x.dtype} on {x.device}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError("rmsnorm: rows and d must be below 2**31")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    build.launch("rmsnorm", _ENTRIES[x.dtype], _ARGTYPES, x.device,
                 x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), float(scale_offset))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
