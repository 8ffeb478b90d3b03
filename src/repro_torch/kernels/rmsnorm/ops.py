"""Wrappers of the fused RMSNorm's entries, ``x (..., d)`` normalised row
by row: ``rmsnorm`` (``x * rsqrt(mean(x²) + eps) * (scale + offset)``)
and ``gated_rmsnorm`` (Mamba2's ``RMSNorm(x * silu(z)) * scale``); and
the gated norm of a row split over the ranks of an axis (Mamba2's
``d_inner`` over "model"), ``split_gated_rmsnorm``: each rank's row sums
of g² (``gated_sumsq``) all-reduced, then each rank's columns normalized
by the whole row's mean (``gated_rmsnorm_stat``).

On a CUDA tensor each launches the hand-written Hopper kernel
(``csrc/rmsnorm.cu``) on the current stream, or raises; on a CPU tensor it
runs the plain version (``ref.rmsnorm_ref``, ``ref.gated_rmsnorm_ref``).
There is no fallback from one to the other. ``_plan`` picks the launch
before it: the threads a row gets, how many 16-byte slots of the row a
lane holds in registers, and the vector or the scalar route.
``rmsnorm.launches``, ``gated_rmsnorm.launches``, ``gated_sumsq.launches``
and ``gated_rmsnorm_stat.launches`` count kernel launches.
Unlike the reference's wrapper they pad nothing: the kernel masks the
last rows and columns itself.

Both have a gradient: where autograd wants the output
(``kernels.needs_grad``) ``rmsnorm`` runs as ``_RMSNorm`` and
``gated_rmsnorm`` as ``_GatedRMSNorm``, whose forwards are the same kernel
(or plain version) and whose backwards, ``rmsnorm_backward`` and
``gated_rmsnorm_backward``, are the derivatives in PyTorch ops (the
reference trains on XLA's autodiff of its plain versions and has no
backward kernel).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, needs_grad
from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_ref,
                                             gated_rmsnorm_stat_ref,
                                             gated_sumsq_ref, rmsnorm_ref)

#: every C entry of csrc/rmsnorm.cu, by (gated, dtype); the split gated
#: norm's two, by ("sumsq" or "stat", dtype): the row sums of g², and the
#: normalization given them
_ENTRIES = {(False, torch.float32): "rmsnorm_f32",
            (False, torch.bfloat16): "rmsnorm_bf16",
            (True, torch.float32): "rmsnorm_gated_f32",
            (True, torch.bfloat16): "rmsnorm_gated_bf16",
            ("sumsq", torch.float32): "rmsnorm_gated_sumsq_f32",
            ("sumsq", torch.bfloat16): "rmsnorm_gated_sumsq_bf16",
            ("stat", torch.float32): "rmsnorm_gated_stat_f32",
            ("stat", torch.bfloat16): "rmsnorm_gated_stat_bf16"}
#: the plan every entry ends with: vec, threads a row, slots a lane
_PLAN_ARGTYPES = [ctypes.c_int] * 3
#: x, scale, y; rows, d; eps, scale_offset; the plan
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + _PLAN_ARGTYPES)
#: x, z, scale, y; rows, d, ldx, ldz; eps; the plan
_GATED_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + _PLAN_ARGTYPES)
#: x, z, sumsq; rows, d, ldx, ldz; vec, threads a row
_SUMSQ_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
#: x, z, scale, sumsq, y; rows, d, ldx, ldz; width, eps; vec, threads a row
_STAT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 2)
#: each entry's ctypes argument types (the stream is appended at launch)
_SIGNATURES = {name: {False: _ARGTYPES, True: _GATED_ARGTYPES,
                     "sumsq": _SUMSQ_ARGTYPES, "stat": _STAT_ARGTYPES}[kind]
               for (kind, _), name in _ENTRIES.items()}
#: threads a block; a row gets one of ROW_THREADS of them
THREADS = 256
ROW_THREADS = (32, 64, 128, 256)
#: the kernel's instances of the most slots a lane holds
LANE_SLOTS = (4, 6, 8, 12, 16)
#: a row gets one warp while a lane holds at most WARP_SLOTS of its slots,
#: else the fewest warps (2 or 4) that leave a lane at most SPLIT_SLOTS
#: (GATED_SLOTS for the gated entry, whose gate costs an exp and a division
#: a value); the widest rows take a whole block. chip_smoke.py's ``plans``
#: lines time every choice at the served widths (PERF.md): at 2048 rows of
#: 2048-3584 bf16 the plain entry is fastest with 4-7 slots a lane, the
#: gated one with 2-4
WARP_SLOTS = 4
SPLIT_SLOTS = 8
GATED_SLOTS = 4
#: the gated instances hold g in fp32 (8 values a slot in bf16, 4 in
#: fp32): the most slots a lane they have instances for
GATED_MOST = {torch.bfloat16: 8, torch.float32: 12}
#: rows up to this many (a decode step's) get a whole block each
DECODE_ROWS = 2


def _slot(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in one 16-byte slot."""
    return 16 // torch.empty((), dtype=dtype).element_size()


@functools.lru_cache(maxsize=4096)
def _plan(rows: int, d: int, dtype: torch.dtype, aligned: bool = True,
          gated: bool = False) -> Tuple[int, int, int]:
    """(vec, tpr, nv) of one launch: ``vec`` the values a load moves (the
    slot's 8 bf16 or 4 fp32 on the vector route, 1 on the scalar route,
    which ragged widths and unaligned operands take: ``aligned`` says every
    base pointer is 16-byte aligned and every row stride a multiple of the
    slot); ``tpr`` the threads a row; ``nv`` the kernel instance's slots a
    lane (at least the row's slots over ``tpr``). Raises for a row wider
    than a block's registers hold."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: the CUDA kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    w = _slot(dtype)
    vec = w if aligned and d % w == 0 else 1
    slots = -(-d // w)
    most = GATED_MOST[dtype] if gated else LANE_SLOTS[-1]
    split = GATED_SLOTS if gated else SPLIT_SLOTS
    if rows <= DECODE_ROWS:
        tries = ((ROW_THREADS[-1], most),)
    else:
        tries = ((ROW_THREADS[0], WARP_SLOTS),
                 *((t, split) for t in ROW_THREADS[1:-1]),
                 (ROW_THREADS[-1], most))
    for tpr, limit in tries:
        per_lane = -(-slots // tpr)
        if per_lane <= limit:
            return vec, tpr, next(n for n in LANE_SLOTS if n >= per_lane)
    raise ValueError(f"rmsnorm: d = {d} is wider than the kernel holds in "
                     f"registers ({ROW_THREADS[-1] * most * w} {dtype} "
                     f"values a row)")


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The one stride, in elements, between the rows of ``t (..., d)`` read
    as ``(rows, d)``; None where its last dim is not contiguous or its
    leading dims do not collapse into one stride of at least d."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    d = t.shape[-1]
    lead = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
    if not lead:
        return d
    for (_, outer), (n, inner) in zip(lead, lead[1:]):
        if outer != inner * n:
            return None
    return lead[-1][1] if lead[-1][1] >= d else None


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                        f"bfloat16, x is {x.dtype}")
    for t in others:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name}: an operand is {t.dtype} on "
                            f"{t.device}, x is {x.dtype} on {x.device}")


def _aligned(*ptrs: int) -> bool:
    return not functools.reduce(int.__or__, ptrs) % 16


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            scale_offset: float = 0.0) -> torch.Tensor:
    """x (..., d), scale (d,) -> (..., d) in x's dtype; fp32 math. Through
    ``_RMSNorm`` where autograd wants the output, else straight to the
    kernel (or, on the CPU, the plain version)."""
    if needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps, scale_offset)
    return _rmsnorm(x, scale, eps, scale_offset)


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6, scale_offset: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rmsnorm`` at (x, scale) for the output gradient
    ``g``, in fp32 with ``w = scale + offset`` and ``r = rsqrt(mean(x²) +
    eps)``: ``dx = r·(g·w − x·r²·mean(x·g·w))``, ``dscale = Σ_rows
    g·x·r``; each cast to its operand's dtype (float64 operands keep
    float64 math)."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    x32, g32 = x.to(f32), g.to(f32)
    r = 1.0 / torch.sqrt(torch.mean(torch.square(x32), dim=-1,
                                    keepdim=True) + eps)
    gw = g32 * (scale.to(f32) + scale_offset)
    dx = r * (gw - x32 * (r * r) * torch.mean(x32 * gw, dim=-1,
                                              keepdim=True))
    dscale = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` as an autograd node: the forward launches the kernel
    (the plain version on the CPU) and keeps the caller's x and scale, not
    the contiguous copies the card's path makes; the backward is
    ``rmsnorm_backward``."""

    @staticmethod
    def forward(ctx, x, scale, eps, scale_offset):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.scale_offset = eps, scale_offset
        return _rmsnorm(x, scale, eps, scale_offset)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g, ctx.eps,
                                      ctx.scale_offset)
        return dx, dscale, None, None


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             scale_offset: float) -> torch.Tensor:
    """The serving path: the kernel on a card tensor, the plain version on
    a CPU one."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, scale_offset)
    _check("rmsnorm", x, scale)
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
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
    plan = _plan(rows, d, x.dtype, _aligned(x.data_ptr(), scale.data_ptr(),
                                            out.data_ptr()))
    build.launch("rmsnorm", _ENTRIES[False, x.dtype], _ARGTYPES, x.device,
                 x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), float(scale_offset), *plan)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x, z (..., d), scale (d,) -> ``RMSNorm(x * silu(z)) * scale`` (...,
    d) in x's dtype; fp32 math. z is read in place: a view whose last dim
    is contiguous and whose rows lie one stride apart (Mamba2's z, a slice
    of the input projection) is not copied; x is made contiguous where it
    is not such a view. Through ``_GatedRMSNorm`` where autograd wants the
    output, else straight to the kernel (or, on the CPU, the plain
    version)."""
    if needs_grad(x, z, scale):
        return _GatedRMSNorm.apply(x, z, scale, eps)
    return _gated_rmsnorm(x, z, scale, eps)


def gated_rmsnorm_backward(x: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, g: torch.Tensor,
                           eps: float = 1e-6
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dx, dz, dscale) of ``gated_rmsnorm`` at (x, z, scale) for the
    output gradient ``g``, in fp32 (float64 for float64 operands) with
    ``σ = sigmoid(z)``, ``s = z·σ``, ``u = x·s``, ``r = rsqrt(mean(u²) +
    eps)`` and ``gw = g·scale``: ``du = r·(gw − u·r²·mean(u·gw))``, ``dx =
    du·s``, ``dz = du·x·σ·(1 + z·(1 − σ))``, ``dscale = Σ_rows g·u·r``;
    each cast to its operand's dtype. ``torch.sigmoid`` is finite at every
    z, so dz is too (the reference's autodiff of its two-branch sigmoid
    gives NaN where |z| ≥ ~89 in fp32)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, z32, g32 = x.to(acc), z.to(acc), g.to(acc)
    sig = torch.sigmoid(z32)
    s = z32 * sig
    u = x32 * s
    r = 1.0 / torch.sqrt(torch.mean(torch.square(u), dim=-1, keepdim=True)
                         + eps)
    gw = g32 * scale.to(acc)
    du = r * (gw - u * (r * r) * torch.mean(u * gw, dim=-1, keepdim=True))
    dx = du * s
    dz = du * x32 * sig * (1.0 + z32 * (1.0 - sig))
    dscale = (g32 * u * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dz.to(z.dtype), dscale.to(scale.dtype)


class _GatedRMSNorm(torch.autograd.Function):
    """``gated_rmsnorm`` as an autograd node: the forward launches the
    gated entry (the plain version on the CPU), which reads z in place;
    the backward is ``gated_rmsnorm_backward``, whose dz autograd carries
    into z's strided slice of the input projection."""

    @staticmethod
    def forward(ctx, x, z, scale, eps):
        ctx.save_for_backward(x, z, scale)
        ctx.eps = eps
        return _gated_rmsnorm(x, z, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, z, scale = ctx.saved_tensors
        dx, dz, dscale = gated_rmsnorm_backward(x, z, scale, g, ctx.eps)
        return dx, dz, dscale, None


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The serving path: the gated entry on card tensors, the plain version
    on CPU ones."""
    if x.device.type == "cpu":
        return gated_rmsnorm_ref(x, z, scale, eps)
    _check("gated_rmsnorm", x, z, scale)
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    if z.shape != x.shape or tuple(scale.shape) != (d,):
        raise ValueError(f"gated_rmsnorm: z {tuple(z.shape)} and scale "
                         f"{tuple(scale.shape)} do not match x "
                         f"{tuple(x.shape)}")
    ldz = _row_stride(z)
    if ldz is None:
        raise ValueError(f"gated_rmsnorm: z (strides {z.stride()}) needs a "
                         f"contiguous last dim and rows one stride apart")
    ldx = _row_stride(x)
    if ldx is None:
        x, ldx = x.contiguous(), d
    if rows >= 2 ** 31 or max(ldx, ldz) >= 2 ** 31:
        raise ValueError("gated_rmsnorm: rows and row strides must be "
                         "below 2**31")
    scale = scale.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return out
    w = _slot(x.dtype)
    aligned = (_aligned(x.data_ptr(), z.data_ptr(), scale.data_ptr(),
                        out.data_ptr()) and not ldx % w and not ldz % w)
    plan = _plan(rows, d, x.dtype, aligned, gated=True)
    build.launch("rmsnorm", _ENTRIES[True, x.dtype], _GATED_ARGTYPES,
                 x.device, x.data_ptr(), z.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), rows, d, ldx, ldz, float(eps), *plan)
    gated_rmsnorm.launches += 1
    return out


gated_rmsnorm.launches = 0


# ---------------------------------------------------------------------------
# the gated norm of a row split over ranks
# ---------------------------------------------------------------------------
def _gated_operands(name: str, x: torch.Tensor, z: torch.Tensor):
    """(x, ldx, ldz, rows, d, vec, tpr) of a split entry's launch: z read in
    place (``_row_stride``), x made contiguous where it is not one stride
    a row; the plan's vector route and threads a row (``_plan``; the
    split entries walk a row's slots in a loop and hold none)."""
    _check(name, x, z)
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    if z.shape != x.shape:
        raise ValueError(f"{name}: z {tuple(z.shape)} does not match x "
                         f"{tuple(x.shape)}")
    ldz = _row_stride(z)
    if ldz is None:
        raise ValueError(f"{name}: z (strides {z.stride()}) needs a "
                         f"contiguous last dim and rows one stride apart")
    ldx = _row_stride(x)
    if ldx is None:
        x, ldx = x.contiguous(), d
    if rows >= 2 ** 31 or max(ldx, ldz) >= 2 ** 31:
        raise ValueError(f"{name}: rows and row strides must be below 2**31")
    w = _slot(x.dtype)
    aligned = (_aligned(x.data_ptr(), z.data_ptr()) and not ldx % w
               and not ldz % w)
    vec, tpr, _ = _plan(max(rows, 1), d, x.dtype, aligned, gated=True)
    return x, ldx, ldz, rows, d, vec, tpr


def gated_sumsq(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x, z (..., d) -> (...,) float32: each row's sum of g² (g = x *
    silu(z), fp32 math), z read in place. The kernel's sum-of-squares
    entry on a card tensor, the plain version (``gated_sumsq_ref``) on a
    CPU one. No gradient: ``split_gated_rmsnorm`` differentiates it."""
    if x.device.type == "cpu":
        return gated_sumsq_ref(x, z)
    x, ldx, ldz, rows, d, vec, tpr = _gated_operands("gated_sumsq", x, z)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0 or d == 0:
        return out.zero_()
    build.launch("rmsnorm", _ENTRIES["sumsq", x.dtype], _SUMSQ_ARGTYPES,
                 x.device, x.data_ptr(), z.data_ptr(), out.data_ptr(), rows,
                 d, ldx, ldz, vec, tpr)
    gated_sumsq.launches += 1
    return out


gated_sumsq.launches = 0


def gated_rmsnorm_stat(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                       sumsq: torch.Tensor, width: int,
                       eps: float = 1e-6) -> torch.Tensor:
    """x, z (..., d) of rows ``width`` wide, scale (d,), sumsq (...,)
    float32 the whole rows' sums of g² -> g / sqrt(sumsq / width + eps) *
    scale (..., d) in x's dtype, z read in place. The kernel's normalize
    entry on card tensors, the plain version (``gated_rmsnorm_stat_ref``)
    on CPU ones."""
    if x.device.type == "cpu":
        return gated_rmsnorm_stat_ref(x, z, scale, sumsq, width, eps)
    x, ldx, ldz, rows, d, vec, tpr = _gated_operands("gated_rmsnorm_stat",
                                                     x, z)
    _check("gated_rmsnorm_stat", x, scale)
    if tuple(scale.shape) != (d,) or tuple(sumsq.shape) != tuple(
            x.shape[:-1]) or sumsq.dtype != torch.float32:
        raise ValueError(f"gated_rmsnorm_stat: scale {tuple(scale.shape)} "
                         f"and sumsq {tuple(sumsq.shape)} {sumsq.dtype} do "
                         f"not match x {tuple(x.shape)}")
    scale = scale.contiguous()
    sumsq = sumsq.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return out
    if vec > 1 and not _aligned(scale.data_ptr(), out.data_ptr()):
        vec = 1
    build.launch("rmsnorm", _ENTRIES["stat", x.dtype], _STAT_ARGTYPES,
                 x.device, x.data_ptr(), z.data_ptr(), scale.data_ptr(),
                 sumsq.data_ptr(), out.data_ptr(), rows, d, ldx, ldz,
                 float(width), float(eps), vec, tpr)
    gated_rmsnorm_stat.launches += 1
    return out


gated_rmsnorm_stat.launches = 0


def split_gated_rmsnorm(x: torch.Tensor, z: torch.Tensor,
                        scale: torch.Tensor, eps: float, axis, width: int,
                        plain: bool = False) -> torch.Tensor:
    """``gated_rmsnorm`` of this rank's d columns of rows ``width`` wide,
    split over ``axis`` (an object with ``all_reduce``: the "model" axis
    of ``sharding.tensor_parallel``): the row sums of g² all-reduced in
    fp32, then this rank's columns normalized by the whole row's mean.
    The kernel's two split entries (``plain``: their plain versions);
    through ``_SplitGatedRMSNorm`` where autograd wants the output."""
    if needs_grad(x, z, scale):
        return _SplitGatedRMSNorm.apply(x, z, scale, eps, axis, width, plain)
    return _split_forward(x, z, scale, eps, axis, width, plain)[0]


def _split_forward(x, z, scale, eps, axis, width, plain):
    sumsq = axis.all_reduce(gated_sumsq_ref(x, z) if plain
                            else gated_sumsq(x, z))
    stat = gated_rmsnorm_stat_ref if plain else gated_rmsnorm_stat
    return stat(x, z, scale, sumsq, width, eps), sumsq


def split_gated_rmsnorm_backward(x: torch.Tensor, z: torch.Tensor,
                                 scale: torch.Tensor, sumsq: torch.Tensor,
                                 g: torch.Tensor, width: int, eps: float,
                                 row_sum) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """(dx, dz, dscale) of the split gated norm: ``gated_rmsnorm_backward``
    with ``r`` from the whole rows' ``sumsq`` and ``mean(u·gw)`` the sum of
    every rank's row sums (``row_sum``: the all-reduce) over ``width``;
    ``dscale`` is this rank's columns'."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, z32, g32 = x.to(acc), z.to(acc), g.to(acc)
    sig = torch.sigmoid(z32)
    s = z32 * sig
    u = x32 * s
    r = 1.0 / torch.sqrt(sumsq.to(acc)[..., None] / width + eps)
    gw = g32 * scale.to(acc)
    dot = row_sum(torch.sum(u * gw, dim=-1))[..., None] / width
    du = r * (gw - u * (r * r) * dot)
    dx = du * s
    dz = du * x32 * sig * (1.0 + z32 * (1.0 - sig))
    dscale = (g32 * u * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dz.to(z.dtype), dscale.to(scale.dtype)


class _SplitGatedRMSNorm(torch.autograd.Function):
    """``split_gated_rmsnorm`` as an autograd node: the forward's two
    entries and the all-reduce between them; the backward is
    ``split_gated_rmsnorm_backward``, its one all-reduce of the row sums
    of u·gw through the same axis."""

    @staticmethod
    def forward(ctx, x, z, scale, eps, axis, width, plain):
        out, sumsq = _split_forward(x, z, scale, eps, axis, width, plain)
        ctx.save_for_backward(x, z, scale, sumsq)
        ctx.eps, ctx.axis, ctx.width = eps, axis, width
        return out

    @staticmethod
    def backward(ctx, g):
        x, z, scale, sumsq = ctx.saved_tensors
        dx, dz, dscale = split_gated_rmsnorm_backward(
            x, z, scale, sumsq, g, ctx.width, ctx.eps, ctx.axis.all_reduce)
        return dx, dz, dscale, None, None, None, None
