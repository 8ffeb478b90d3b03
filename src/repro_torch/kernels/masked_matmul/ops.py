"""Wrappers of the column-masked GEMM: ``a (..., K) @ b (K, N) * col_mask``
(``masked_matmul``), and the same with ``b`` given as uint8 codes that the
kernel dequantizes as it loads them (``masked_matmul_q8``).

On a CUDA tensor each launches one of the hand-written Hopper kernels of
``csrc/masked_matmul.cu`` on the current stream, or raises; on a CPU tensor
it runs the plain version (``ref.masked_matmul_ref``, after the dequant for
codes). There is no fallback from one to the other. ``_plan`` picks the
entry, and its launch plan, from B's dtype and the shape before the launch:

* bf16 with K and N multiples of 8: the decode GEMV up to ``GEMV_MAX_ROWS``
  rows, the wgmma/TMA tiles above; other bf16 shapes the CUDA-core tiles;
* float32, or uint8 codes: the split-K GEMV up to ``GEMV_F32_MAX_ROWS``
  rows, else the split-K cluster tiles.

``masked_matmul.launches`` counts kernel launches of both wrappers, so a
run can show that its GEMMs went through the kernels;
``masked_matmul.route_launches`` counts them by entry.

``masked_matmul`` has a gradient: where autograd wants its output
(``kernels.needs_grad`` of ``a`` or ``b``) it runs as ``_MaskedMatmul``,
whose forward is the same kernel (or plain version) and whose backward is
``masked_matmul_backward``, two matrix products in PyTorch ops (no TPU
kernel computes them: the reference trains on XLA's autodiff). The mask
gets no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.device import exact_fp32
from repro_torch.kernels import build, needs_grad
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

#: every C entry of csrc/masked_matmul.cu, by route
_ENTRIES = {"cuda_cores_bf16": "masked_matmul_bf16",
            "tiles": "masked_matmul_bf16_tiles",
            "gemv": "masked_matmul_bf16_gemv",
            "f32_splitk": "masked_matmul_f32_splitk",
            "f32_gemv": "masked_matmul_f32_gemv",
            "q8_splitk": "masked_matmul_q8_splitk",
            "q8_gemv": "masked_matmul_q8_gemv"}
#: A, B, mask, C pointers; M, N, K
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
#: the float32 routes add the host's plan: tile, split, vec
_PLANNED_ARGTYPES = _ARGTYPES + [ctypes.c_int] * 3
#: A, codes, scale, zero, mask, C pointers; M, N, K; tile, split, vec
_Q8_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
#: each entry's ctypes argument types (the stream is appended at launch)
_SIGNATURES = {
    **dict.fromkeys(_ENTRIES.values(), _ARGTYPES),
    _ENTRIES["f32_splitk"]: _PLANNED_ARGTYPES,
    _ENTRIES["f32_gemv"]: _PLANNED_ARGTYPES,
    _ENTRIES["q8_splitk"]: _Q8_ARGTYPES,
    _ENTRIES["q8_gemv"]: _Q8_ARGTYPES}
#: the most rows the bf16 GEMV takes: from 3 rows on (it then reads B once
#: per 8 rows) the wgmma tiles are faster; the crossover chip_smoke.py
#: measures, PERF.md
GEMV_MAX_ROWS = 2
#: the bf16 GEMV holds its rows of A in shared memory: at most 8 x K bf16
GEMV_MAX_K = 12288
#: the most rows the float32 / codes GEMV takes: it reads B once per 4 rows,
#: and still beats the split-K tiles at 24 rows of dense14's shape, not at
#: 32 (chip_smoke.py's crossover, PERF.md)
GEMV_F32_MAX_ROWS = 24
#: the float32 GEMV holds its rows of A for its K share in shared memory
GEMV_F32_MAX_KPER = 8192
#: the float32 / codes GEMV's split leaves every lane of a block at least
#: this many rows of B to read (a deeper split would idle lanes)
GEMV_F32_MIN_READS = 4
#: the operand dtypes of the float32 and bf16 routes
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
#: streaming multiprocessors of an H100 SXM: a launch wants this many blocks
SMS = 132
#: blocks of a thread-block cluster, the K split: the portable maximum
CLUSTER_MAX = 8
#: the split-K tiles: columns a tile, K depth of a slice, and the fewest
#: slices a block of a split keeps
SPLITK_BN = 32
SPLITK_BK = 32
SPLITK_MIN_SLICES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemv_f32_plan(q8: bool, M: int, K: int, N: int,
                   aligned: bool) -> Tuple[int, int, int]:
    """(rows of A a block, split, vec) of the float32 / codes GEMV: 16-byte
    reads (4 floats, 16 codes) where N and alignment allow, a block of 64
    columns read by 16 or 4 lanes; else single elements, 32 columns by 32
    lanes. The split is as deep as K gives every lane of a block
    ``GEMV_F32_MIN_READS`` rows of B."""
    wide = 16 if q8 else 4
    vec = wide if aligned and N % wide == 0 else 1
    lanes_k = 256 // (64 // vec if vec > 1 else 32)
    split = max(1, min(CLUSTER_MAX, K // (lanes_k * GEMV_F32_MIN_READS)))
    rows = 1 if M == 1 else 2 if M == 2 else 4
    return rows, split, vec


def _splitk_plan(M: int, K: int, N: int) -> Tuple[int, int]:
    """(rows a tile, split) of the split-K tiles: K split as deep as
    ``CLUSTER_MAX`` allows while every block keeps ``SPLITK_MIN_SLICES``
    slices; 64-row tiles where tiles x split still reaches ``SMS``, else
    32 rows. The deepest split and the larger tile measured fastest, or
    within 10% of it, at every AlexNet conv (PERF.md)."""
    split = max(1, min(CLUSTER_MAX,
                       _cdiv(K, SPLITK_BK) // SPLITK_MIN_SLICES))
    cols = _cdiv(N, SPLITK_BN)
    bm = 64 if _cdiv(M, 64) * cols * split >= SMS else 32
    return bm, split


@functools.lru_cache(maxsize=4096)
def _plan(dtype: torch.dtype, M: int, K: int, N: int,
          aligned: bool = True) -> Tuple[str, Tuple[int, ...]]:
    """The C entry, and the plan its launch takes, for an (M, K) @ (K, N)
    product whose B is of ``dtype`` (float32, bfloat16, or uint8 codes with
    a float32 A). The bf16 Hopper routes read rows of 16 bytes (TMA's stride
    rule, the GEMV's vector loads): they need K and N multiples of 8 and
    16-byte aligned operands (``aligned``); so do the 16-byte reads of the
    float32 GEMV."""
    if dtype in (torch.float32, torch.uint8):
        q8 = dtype == torch.uint8
        prefix = "q8" if q8 else "f32"
        if M <= GEMV_F32_MAX_ROWS:
            rows, split, vec = _gemv_f32_plan(q8, M, K, N, aligned)
            if _cdiv(K, split) <= GEMV_F32_MAX_KPER:
                return _ENTRIES[f"{prefix}_gemv"], (rows, split, vec)
        bm, split = _splitk_plan(M, K, N)
        vec = 4 if aligned and N % 4 == 0 else 1
        return _ENTRIES[f"{prefix}_splitk"], (bm, split, vec)
    if dtype != torch.bfloat16:
        raise TypeError(f"masked_matmul: the CUDA kernel takes float32 or "
                        f"bfloat16 operands (or uint8 codes for B), got "
                        f"{dtype}")
    if not aligned or K % 8 or N % 8:
        return _ENTRIES["cuda_cores_bf16"], ()
    if M <= GEMV_MAX_ROWS and K <= GEMV_MAX_K:
        return _ENTRIES["gemv"], ()
    return _ENTRIES["tiles"], ()


def _route(dtype: torch.dtype, M: int, K: int, N: int,
           aligned: bool = True) -> str:
    """The C entry ``_plan`` picks."""
    return _plan(dtype, M, K, N, aligned)[0]


def _check_cuda_operands(a: torch.Tensor, b: torch.Tensor,
                         col_mask: torch.Tensor, b_dtype: torch.dtype,
                         *more: Tuple[str, torch.Tensor]) -> None:
    """Device, dtype, shape and contiguity of every operand (``more``: the
    codes' float32 (N,) scale and zero), the cheap comparisons first: the
    wrapper's host time bounds a small GEMM's."""
    if a.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"masked_matmul: the CUDA kernel takes float32 or "
                        f"bfloat16, a is {a.dtype}")
    K, N = a.shape[-1], b.shape[-1]
    dev = a.get_device()
    for name, t, dtype, shape in (
            ("a", a, a.dtype, None), ("b", b, b_dtype, (K, N)),
            ("col_mask", col_mask, torch.float32, (N,)),
            *[(n, t, torch.float32, (N,)) for n, t in more]):
        if t.get_device() != dev:
            raise ValueError(f"masked_matmul: {name} is on {t.device}, "
                             f"a is on {a.device}")
        if t.dtype != dtype:
            raise TypeError(f"masked_matmul: the CUDA kernel takes {name} "
                            f"as {dtype}, got {t.dtype}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"masked_matmul: shapes a {tuple(a.shape)}, "
                             f"b {tuple(b.shape)}, {name} "
                             f"{tuple(t.shape)} do not line up")
        if not t.is_contiguous():
            raise ValueError(f"masked_matmul: {name} must be contiguous")
    if max(a.numel() // K, K) >= 2 ** 31 or N > 65535 * SPLITK_BN:
        raise ValueError("masked_matmul: a dimension exceeds the launch "
                         "grid (M, K < 2**31, N <= 65535*32)")


def masked_matmul(a: torch.Tensor, b: torch.Tensor,
                  col_mask: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) * col_mask (N,) -> (..., N), fp32 accumulation,
    pruned columns exact zeros, output in a's dtype. On the card a
    bfloat16 ``a`` takes a bfloat16 ``b``; the mask is read as float32
    (a mask of another dtype is converted, it holds only 0s and 1s).
    Through ``_MaskedMatmul`` where autograd wants the output."""
    if needs_grad(a, b):
        return _MaskedMatmul.apply(a, b, col_mask)
    return _masked_matmul(a, b, col_mask)


def masked_matmul_backward(a: torch.Tensor, b: torch.Tensor,
                           col_mask: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dA, dB) of ``masked_matmul`` for the output gradient ``g``: with
    ``gm = g·mask``, ``dA = gm @ Bᵀ`` and ``dB = Aᵀ @ gm`` (A's leading
    dims flattened into rows), so a pruned column's dB is exactly zero.
    The products run in the operands' dtype where A and B share it (bf16
    on the tensor cores, fp32 with TF32 off), else in fp32; each result
    is cast to its operand's dtype."""
    ct = (a.dtype if a.dtype == b.dtype
          else torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                   torch.float32))
    K, N = b.shape
    gm = (g.to(ct) * col_mask.to(ct))
    with exact_fp32():
        da = gm @ b.to(ct).T
        db = a.to(ct).reshape(-1, K).T @ gm.reshape(-1, N)
    return da.to(a.dtype), db.to(b.dtype)


class _MaskedMatmul(torch.autograd.Function):
    """``masked_matmul`` as an autograd node: the forward launches the
    kernel (the plain version on the CPU) and keeps the caller's
    operands; the backward is ``masked_matmul_backward``."""

    @staticmethod
    def forward(ctx, a, b, col_mask):
        ctx.save_for_backward(a, b, col_mask)
        return _masked_matmul(a, b, col_mask)

    @staticmethod
    def backward(ctx, g):
        a, b, col_mask = ctx.saved_tensors
        da, db = masked_matmul_backward(a, b, col_mask, g)
        return da, db, None


def _masked_matmul(a: torch.Tensor, b: torch.Tensor,
                   col_mask: torch.Tensor) -> torch.Tensor:
    """The serving path: the kernel on card tensors, the plain version on
    CPU ones."""
    lead = a.shape[:-1]
    K = a.shape[-1]
    N = b.shape[1]
    M = math.prod(lead)
    if M == 0 or N == 0 or K == 0:
        # an empty M or N yields an empty output, and K == 0 is an empty
        # contraction: exact zeros, matching the plain version
        return torch.zeros((*lead, N), dtype=a.dtype, device=a.device)
    if not a.is_cuda:
        if a.device.type == "cpu":
            return masked_matmul_ref(a, b, col_mask)
        raise ValueError(f"masked_matmul: no kernel for device {a.device}")
    if col_mask.dtype != torch.float32:
        col_mask = col_mask.to(torch.float32)
    _check_cuda_operands(a, b, col_mask, a.dtype)
    aligned = (a.data_ptr() | b.data_ptr()) % 16 == 0
    return _launch(a, b, col_mask, *_plan(a.dtype, M, K, N, aligned))


def masked_matmul_q8(a: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor,
                     col_mask: torch.Tensor) -> torch.Tensor:
    """a (..., K) float32 @ dequant(codes) (K, N) * col_mask (N,) -> (..., N)
    float32, where dequant(codes) = codes * scale + zero with ``scale`` and
    ``zero`` per column (N,) or one pair per tensor, which is broadcast.
    On the card the kernel dequantizes each code as it loads it, rounding
    the product and the sum as ``quant.dequantize_weights`` does, so it
    multiplies by the same float32 B; on the CPU the wrapper dequantizes,
    then runs the plain version."""
    lead = a.shape[:-1]
    K, N = codes.shape
    M = math.prod(lead)
    cuda = a.is_cuda
    if (not cuda and a.device.type == "cpu") or M == 0 or N == 0 or K == 0:
        b = codes.to(torch.float32) * scale + zero
        return masked_matmul(a, b, col_mask)
    if not cuda:
        raise ValueError(f"masked_matmul: no kernel for device {a.device}")
    if scale.shape != (N,) or zero.shape != (N,):   # one pair a tensor
        scale, zero = (t.to(device=a.device, dtype=torch.float32)
                       .reshape(-1).expand(N).contiguous()
                       for t in (scale, zero))
    if col_mask.dtype != torch.float32:
        col_mask = col_mask.to(torch.float32)
    _check_cuda_operands(a, codes, col_mask, torch.uint8, ("scale", scale),
                         ("zero", zero))
    if a.dtype != torch.float32:
        raise TypeError(f"masked_matmul: codes take a float32 a, got "
                        f"{a.dtype}")
    aligned = codes.data_ptr() % 16 == 0
    symbol, plan = _plan(torch.uint8, M, K, N, aligned)
    out = torch.empty((*lead, N), dtype=torch.float32, device=a.device)
    build.launch("masked_matmul", symbol, _SIGNATURES[symbol], a.device,
                 a.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                 zero.data_ptr(), col_mask.data_ptr(), out.data_ptr(), M, N,
                 K, *plan)
    _count(symbol)
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, col_mask: torch.Tensor,
            symbol: str, plan: Tuple[int, ...] = ()) -> torch.Tensor:
    """Launch entry ``symbol`` of float32 or bf16 operands with ``plan`` on
    checked CUDA operands (``a`` (..., K), ``b`` (K, N), a float32 mask)
    into a new output, and count it."""
    K, N = a.shape[-1], b.shape[1]
    out = torch.empty((*a.shape[:-1], N), dtype=a.dtype, device=a.device)
    build.launch("masked_matmul", symbol, _SIGNATURES[symbol], a.device,
                 a.data_ptr(), b.data_ptr(), col_mask.data_ptr(),
                 out.data_ptr(), a.numel() // K, N, K, *plan)
    _count(symbol)
    return out


def _count(symbol: str) -> None:
    masked_matmul.launches += 1
    masked_matmul.route_launches[symbol] += 1


masked_matmul.launches = 0
masked_matmul.route_launches = dict.fromkeys(_ENTRIES.values(), 0)
