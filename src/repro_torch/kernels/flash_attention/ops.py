"""Wrapper of flash attention in the model layout: q (B,Sq,H,D), k/v
(B,Sk,Hkv,D) -> (B,Sq,H,D).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.attention_ref``). There is no
fallback from one to the other. ``flash_attention.launches`` counts kernel
launches. The kernel reads the (B, S, H, D) strides itself and
bounds-checks ragged tiles, so unlike the reference's wrapper this one
neither transposes nor pads.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 3)
HEAD_DIMS = (64, 128, 192, 256)


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
                    seq_k: Optional[int] = None) -> torch.Tensor:
    """Model layout in/out: q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D).

    Query and key positions are 0..S-1; keys at or past ``seq_k`` (default
    Sk, the true key length) are masked. fp32 scores, softmax and
    accumulator; output in q's dtype."""
    Sk = k.shape[1]
    seq_k = Sk if seq_k is None else int(seq_k)
    if not 0 <= seq_k <= Sk:
        raise ValueError(f"flash_attention: seq_k {seq_k} outside 0..{Sk}")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return attention_ref(q, k[:, :seq_k], v[:, :seq_k], causal=causal,
                             window=window, scale=scale)
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
                 int(window) if window is not None else 0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
