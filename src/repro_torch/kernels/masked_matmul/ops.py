"""Wrapper of the column-masked GEMM: ``a (..., K) @ b (K, N) * col_mask``.

On a CUDA tensor it launches one of the hand-written Hopper kernels of
``csrc/masked_matmul.cu`` on the current stream, or raises; on a CPU tensor
it runs the plain version (``ref.masked_matmul_ref``). There is no fallback
from one to the other. ``_route`` picks the entry from the dtype and shape
before the launch: bf16 products with K and N multiples of 8 go to the
decode GEMV up to ``GEMV_MAX_ROWS`` rows and to the wgmma/TMA tiles above;
float32 products, and bf16 ones of other shapes, to the CUDA-core tiles.
``masked_matmul.launches`` counts kernel launches, so a run can show that
its GEMMs went through the kernel; ``masked_matmul.route_launches`` counts
them by entry.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

#: every C entry of csrc/masked_matmul.cu, by route
_ENTRIES = {"cuda_cores_f32": "masked_matmul_f32",
            "cuda_cores_bf16": "masked_matmul_bf16",
            "tiles": "masked_matmul_bf16_tiles",
            "gemv": "masked_matmul_bf16_gemv"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
#: the most rows the GEMV takes: from 3 rows on (it then reads B once per 8
#: rows) the wgmma tiles are faster; the crossover chip_smoke.py measures,
#: PERF.md
GEMV_MAX_ROWS = 2
#: the GEMV holds its rows of A in shared memory: at most 8 x K bf16
GEMV_MAX_K = 12288


def _route(dtype: torch.dtype, M: int, K: int, N: int,
           aligned: bool = True) -> str:
    """The C entry for an (M, K) @ (K, N) product with operands of
    ``dtype``. The Hopper routes read rows of 16 bytes (TMA's stride rule,
    the GEMV's vector loads): they need bf16, K and N multiples of 8 and
    16-byte aligned operands (``aligned``)."""
    if dtype == torch.float32:
        return _ENTRIES["cuda_cores_f32"]
    if dtype != torch.bfloat16:
        raise TypeError(f"masked_matmul: the CUDA kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    if not aligned or K % 8 or N % 8:
        return _ENTRIES["cuda_cores_bf16"]
    if M <= GEMV_MAX_ROWS and K <= GEMV_MAX_K:
        return _ENTRIES["gemv"]
    return _ENTRIES["tiles"]


def _check_cuda_operands(a: torch.Tensor, b: torch.Tensor,
                         col_mask: torch.Tensor) -> None:
    K, N = a.shape[-1], b.shape[1]
    if a.dtype not in (torch.float32, torch.bfloat16):
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
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return _launch(a, b, col_mask, _route(a.dtype, M, K, N, aligned))


def _launch(a: torch.Tensor, b: torch.Tensor, col_mask: torch.Tensor,
            symbol: str) -> torch.Tensor:
    """Launch entry ``symbol`` on checked CUDA operands (``a`` (..., K),
    ``b`` (K, N), a float32 mask) into a new output, and count it."""
    K, N = a.shape[-1], b.shape[1]
    out = torch.empty((*a.shape[:-1], N), dtype=a.dtype, device=a.device)
    build.launch("masked_matmul", symbol, _ARGTYPES, a.device, a.data_ptr(),
                 b.data_ptr(), col_mask.data_ptr(), out.data_ptr(),
                 a.numel() // K, N, K)
    masked_matmul.launches += 1
    masked_matmul.route_launches[symbol] += 1
    return out


masked_matmul.launches = 0
masked_matmul.route_launches = dict.fromkeys(_ENTRIES.values(), 0)
