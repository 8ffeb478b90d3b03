"""Wrapper of the chunked SSD scan: xh (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
(B,S,G,N), head_mask (H,) -> (y (B,S,H,P) in xh's dtype, state (B,H,P,N)
float32).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) on the current stream, or raises; on a CPU tensor it
runs the plain version (``ref.ssd_scan_ref``). There is no fallback from
one to the other. ``ssd_scan.launches`` counts kernel launches. Unlike the
reference's wrapper this one pads nothing: the kernel bounds-checks the
ragged last chunk, walks 64-step chunks whatever ``chunk`` says (the result
does not depend on the chunk length in exact arithmetic), and reads x, B and
C through their batch and step strides, so the slices of the Mamba2 block's
conv output go in without a copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_ENTRIES = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
#: the (P, N) head and state sizes the kernel is built for
SHAPES = ((64, 64), (64, 128))


def _strides_ok(t: torch.Tensor) -> bool:
    """Innermost dimension contiguous and the one before it packed
    against it: the kernel adds the batch and step strides only."""
    return t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]


def _check_cuda_operands(xh, dt, A, Bm, Cm, head_mask) -> None:
    if xh.dtype not in _ENTRIES:
        raise TypeError(f"ssd_scan: the CUDA kernel takes float32 or "
                        f"bfloat16, xh is {xh.dtype}")
    for name, t, dtype in (("Bm", Bm, xh.dtype), ("Cm", Cm, xh.dtype),
                           ("dt", dt, torch.float32),
                           ("A", A, torch.float32),
                           ("head_mask", head_mask, torch.float32)):
        if t.dtype != dtype or t.device != xh.device:
            raise TypeError(f"ssd_scan: {name} is {t.dtype} on {t.device}, "
                            f"expected {dtype} on {xh.device}")
    if xh.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: shapes xh {tuple(xh.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(Bm.shape[:2]) != (B, S) or tuple(dt.shape) != (B, S, H)
            or tuple(A.shape) != (H,) or tuple(head_mask.shape) != (H,)
            or G == 0 or H % G):
        raise ValueError(f"ssd_scan: xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, head_mask "
                         f"{tuple(head_mask.shape)} do not line up "
                         f"(H % G == 0)")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: the CUDA kernel takes (P, N) in "
                         f"{SHAPES}, got {(P, N)}")
    if B > 65535 or max(xh.stride(0), Bm.stride(0), dt.stride(0),
                        S * H * P) >= 2 ** 31:
        raise ValueError("ssd_scan: a dimension exceeds the kernel's int "
                         "arguments (B <= 65535, batch strides < 2**31)")


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             head_mask: Optional[torch.Tensor] = None,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B,S,H,P); dt (B,S,H) post-softplus, float32; A (H,) negative,
    float32; Bm/Cm (B,S,G,N) like xh; head_mask (H,) or None (all heads).
    Returns (y (B,S,H,P) in xh's dtype, y multiplied by head_mask; final
    state (B,H,P,N) float32, every head unmasked). ``chunk`` is the plain
    version's chunk length; the kernel walks its own."""
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, dt, A, Bm, Cm, head_mask, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    if head_mask is None:
        head_mask = torch.ones((H,), dtype=torch.float32, device=xh.device)
    _check_cuda_operands(xh, dt, A, Bm, Cm, head_mask)
    if not _strides_ok(xh):
        xh = xh.contiguous()
    if not (_strides_ok(Bm) and _strides_ok(Cm)
            and Bm.stride()[:2] == Cm.stride()[:2]):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    dt, A, head_mask = dt.contiguous(), A.contiguous(), head_mask.contiguous()
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    if B == 0 or H == 0:
        return y, state
    build.launch("ssd_scan", _ENTRIES[xh.dtype], _ARGTYPES, xh.device,
                 xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), head_mask.data_ptr(), y.data_ptr(),
                 state.data_ptr(), B, S, H, Bm.shape[2], P, N,
                 xh.stride(0), xh.stride(1), Bm.stride(0), Bm.stride(1),
                 dt.stride(0), dt.stride(1))
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
