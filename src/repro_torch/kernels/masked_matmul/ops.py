"""Wrapper of the column-masked GEMM: ``a (..., K) @ b (K, N) * col_mask``.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/masked_matmul.cu``: ``masked_matmul_f32`` for float32 operands,
``masked_matmul_bf16`` for bfloat16 ones) on the current stream, or raises;
on a CPU tensor it runs the plain version (``ref.masked_matmul_ref``).
There is no fallback from one to the other. ``masked_matmul.launches``
counts kernel launches, so a run can show that its GEMMs went through the
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

_ENTRIES = {torch.float32: "masked_matmul_f32",
            torch.bfloat16: "masked_matmul_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3


def _check_cuda_operands(a: torch.Tensor, b: torch.Tensor,
                         col_mask: torch.Tensor) -> None:
    K, N = a.shape[-1], b.shape[1]
    if a.dtype not in _ENTRIES:
        raise TypeError(f"masked_matmul: the CUDA kernel takes float32 or "
                        f"bfloat16, a is {a.dtype}")
    for name, t, dtype in (("a", a, a.dtype), ("b", b, a.dtype),
                           ("col_mask", col_mask, torch.float32)):
        if t.device != a.device:
            raise ValueError(f"masked_matmul: {name} is on {t.device}, "
                             f"a is on {a.device}")
        if t.dtype != dtype:
            raise TypeError(f"masked_matmul: the CUDA kernel takes {name} "
                            f"as {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"masked_matmul: {name} must be contiguous")
    if b.dim() != 2 or b.shape[0] != K or tuple(col_mask.shape) != (N,):
        raise ValueError(f"masked_matmul: shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, col_mask "
                         f"{tuple(col_mask.shape)} do not line up")
    if max(a.numel() // K, K) >= 2 ** 31 or N > 65535 * 64:
        raise ValueError("masked_matmul: a dimension exceeds the launch "
                         "grid (M, K < 2**31, N <= 65535*64)")


def masked_matmul(a: torch.Tensor, b: torch.Tensor,
                  col_mask: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) * col_mask (N,) -> (..., N), fp32 accumulation,
    pruned columns exact zeros, output in a's dtype. On the card a
    bfloat16 ``a`` takes a bfloat16 ``b``; the mask is read as float32
    (a mask of another dtype is converted, it holds only 0s and 1s)."""
    lead = a.shape[:-1]
    K = a.shape[-1]
    N = b.shape[1]
    M = math.prod(lead)
    if M == 0 or N == 0 or K == 0:
        # an empty M or N yields an empty output, and K == 0 is an empty
        # contraction: exact zeros, matching the plain version
        return torch.zeros((*lead, N), dtype=a.dtype, device=a.device)
    if a.device.type == "cpu":
        return masked_matmul_ref(a, b, col_mask)
    if a.device.type != "cuda":
        raise ValueError(f"masked_matmul: no kernel for device {a.device}")
    if col_mask.dtype != torch.float32:
        col_mask = col_mask.to(torch.float32)
    _check_cuda_operands(a, b, col_mask)
    out = torch.empty((*lead, N), dtype=a.dtype, device=a.device)
    build.launch("masked_matmul", _ENTRIES[a.dtype], _ARGTYPES, a.device,
                 a.data_ptr(), b.data_ptr(), col_mask.data_ptr(),
                 out.data_ptr(), M, N, K)
    masked_matmul.launches += 1
    return out


masked_matmul.launches = 0
