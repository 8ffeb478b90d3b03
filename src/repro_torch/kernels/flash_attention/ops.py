"""Wrapper of flash attention in the model layout: q (B,Sq,H,D), k/v
(B,Sk,Hkv,D) -> (B,Sq,H,D).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.attention_ref``). There is no
fallback from one to the other. ``flash_attention.launches`` counts kernel
launches. The kernel reads the (B, S, H, D) strides itself and
bounds-checks ragged tiles, so unlike the reference's wrapper this one
neither transposes nor pads.

``flash_attention`` has a gradient: where autograd wants its output
(``kernels.needs_grad`` of q, k or v) it runs as ``_FlashAttention``,
whose forward is the same kernel (or plain version) and whose backward is
``flash_attention_backward`` in PyTorch ops (the reference trains on XLA's
autodiff of its plain attention and has no backward kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import exact_fp32
from repro_torch.kernels import build, needs_grad
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 4)
HEAD_DIMS = (64, 80, 128, 192, 256)


def check_head_dim(D: int) -> None:
    """Raise ``ValueError`` for a head dim the CUDA kernel has no instance
    of (the plain version takes any)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head "
                         f"dims {HEAD_DIMS}, got {D}")


def _check_cuda_operands(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 "
                        f"or bfloat16, q is {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention: {name} is {t.dtype} on "
                            f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not line up (H % Hkv == 0)")
    check_head_dim(D)
    if H > 65535 or B > 65535 or max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention: a dimension exceeds the launch "
                         "grid (H, B <= 65535, sizes < 2**31)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    seq_k: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Model layout in/out: q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D).

    Key positions are 0..Sk-1 and query row i sits at ``q_offset + i`` (0
    for self-attention; a sequence block's first position where its
    queries attend the keys of every position before it); keys at or past
    ``seq_k`` (default Sk, the true key length) are masked. fp32 scores,
    softmax and accumulator; output in q's dtype. Through
    ``_FlashAttention`` where autograd wants the output."""
    Sk = k.shape[1]
    seq_k = Sk if seq_k is None else int(seq_k)
    if not 0 <= seq_k <= Sk:
        raise ValueError(f"flash_attention: seq_k {seq_k} outside 0..{Sk}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, scale, seq_k,
                                     q_offset)
    return _flash_attention(q, k, v, causal, window, scale, seq_k, q_offset)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, g: torch.Tensor, causal: bool,
                             window: Optional[int], scale: float,
                             seq_k: int, q_offset: int = 0):
    """(dQ, dK, dV) of ``flash_attention`` for the output gradient ``g``,
    one KV head at a time so that the (Sq, Sk) float32 buffers hold one
    group's heads: P recomputed in fp32 from Q and K under the forward's
    causal, window and ``seq_k`` masks at its ``q_offset``, ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P∘(dP − rowsum(P∘dP))``, ``dQ = scale·dS K``, ``dK =
    scale·dSᵀ Q``; a KV head's dK and dV summed over its group. Keys at or
    past ``seq_k`` get zero. The products run in fp32 with TF32 off
    (float64 for float64 operands); each result is cast to its operand's
    dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    f32 = torch.promote_types(q.dtype, torch.float32)
    dq = torch.empty((B, Sq, H, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, Sk, Hkv, v.shape[-1]), dtype=f32, device=q.device)
    d = (torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
         - torch.arange(seq_k, device=q.device)[None, :])
    ok = torch.ones((Sq, seq_k), dtype=torch.bool, device=q.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    with exact_fp32():
        for h in range(Hkv):
            heads = slice(h * group, (h + 1) * group)
            qh = q[:, :, heads].to(f32)                   # (B, Sq, G, D)
            gh = g[:, :, heads].to(f32)
            kh = k[:, :seq_k, h].to(f32)                  # (B, Sk', D)
            vh = v[:, :seq_k, h].to(f32)
            p = torch.softmax(torch.einsum("bqgd,bkd->bgqk", qh, kh)
                              .mul_(scale).masked_fill_(~ok, NEG_INF),
                              dim=-1)
            dv[:, :seq_k, h] = torch.einsum("bgqk,bqgd->bkd", p, gh)
            dp = torch.einsum("bqgd,bkd->bgqk", gh, vh)
            ds = dp.sub_((p * dp).sum(-1, keepdim=True)).mul_(p)
            del p, dp
            dq[:, :, heads] = torch.einsum("bgqk,bkd->bqgd", ds,
                                           kh).mul_(scale)
            dk[:, :seq_k, h] = torch.einsum("bgqk,bqgd->bkd", ds,
                                            qh).mul_(scale)
            del ds
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` as an autograd node: the forward launches the
    kernel (the plain version on the CPU) and keeps the caller's q, k and
    v, not the contiguous copies the card's path makes; the backward is
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, seq_k, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, seq_k, q_offset)
        return _flash_attention(q, k, v, causal, window, scale, seq_k,
                                q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, g, *ctx.args),
                None, None, None, None, None)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: Optional[int], scale: float,
                     seq_k: int, q_offset: int = 0) -> torch.Tensor:
    """The serving path: the kernel on card tensors, the plain version on
    CPU ones."""
    Sk = k.shape[1]
    if q.device.type == "cpu":
        return attention_ref(q, k[:, :seq_k], v[:, :seq_k], causal=causal,
                             window=window, scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda_operands(q, k, v)
    B, Sq, H, D = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.launch("flash_attention", _ENTRIES[q.dtype], _ARGTYPES, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, k.shape[2], D, seq_k, float(scale),
                 int(causal), int(window is not None),
                 int(window) if window is not None else 0, q_offset)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
