"""Wrapper of the chunked SSD scan: xh (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
(B,S,G,N), head_mask (H,) -> (y (B,S,H,P) in xh's dtype, state (B,H,P,N)
float32).

On a CUDA tensor it launches the hand-written Hopper kernels
(``csrc/ssd_scan.cu``) on the current stream, or raises; on a CPU tensor it
runs the plain version (``ref.ssd_scan_ref``). There is no fallback from
one to the other. One call is one C entry: for bf16 inputs three launches
(chunk states, the state pass across chunks, the outputs; chunks of 256
steps on the tensor cores, with a float32 workspace this wrapper
allocates), for float32 inputs the one-block-per-head kernel (64-step
chunks; the result does not depend on the chunk length in exact
arithmetic). ``ssd_scan.launches`` counts calls. Unlike the reference's
wrapper this one pads nothing: the kernels bound-check the ragged last
chunk and read x, B and C through their batch and step strides, so the
slices of the Mamba2 block's conv output go in without a copy.

Where autograd wants its outputs (``kernels.needs_grad``) the scan runs as
``_SSDScan``, whose forward is the same kernel (or plain version) and
whose backward is ``ssd_scan_backward``, the derivative of the chunked
form in PyTorch ops (the reference trains on XLA's autodiff of its plain
``ssd_chunked`` and has no backward kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import exact_fp32
from repro_torch.kernels import build, needs_grad
from repro_torch.kernels.ssd_scan.ref import _segsum, ssd_scan_ref

_ENTRIES = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
#: the (P, N) head and state sizes the kernel is built for
SHAPES = ((64, 64), (64, 128))
#: steps a chunk of the bf16 entry (its workspace is per chunk)
CHUNK = 256


def _strides_ok(t: torch.Tensor) -> bool:
    """Innermost dimension contiguous and the one before it packed
    against it: the kernel adds the batch and step strides only. The bf16
    entry copies rows of 16 bytes: there the address and the batch and
    step strides must be multiples of 16 bytes too."""
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return (t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
            and t.stride(1) % 8 == 0)


def _kernel_layout(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, B and C as the kernels read them: each passes ``_strides_ok``, and
    B and C share their batch and step strides. A tensor that does not is
    copied into new memory (``contiguous`` alone would hand back a
    contiguous view whose address breaks the bf16 entry's 16-byte rule)."""
    def fresh(t):
        return t.clone(memory_format=torch.contiguous_format)
    if not _strides_ok(xh):
        xh = fresh(xh)
    if not (_strides_ok(Bm) and _strides_ok(Cm)
            and Bm.stride()[:2] == Cm.stride()[:2]):
        Bm, Cm = fresh(Bm), fresh(Cm)
    return xh, Bm, Cm


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
    version's chunk length, and the backward's; the kernel walks its own.
    Through ``_SSDScan`` where autograd wants the outputs, else straight
    to the kernel (or, on the CPU, the plain version)."""
    if needs_grad(xh, dt, A, Bm, Cm):
        return _SSDScan.apply(xh, dt, A, Bm, Cm, head_mask, chunk)
    return _ssd_scan(xh, dt, A, Bm, Cm, head_mask, chunk)


def _chunked(t: torch.Tensor, Q: int, acc: torch.dtype) -> torch.Tensor:
    """(B, S, K, D) -> (B, nc, K, Q, D) in ``acc``, the last chunk padded
    with zeros; (B, S, K) -> (B, nc, K, Q)."""
    B, S = t.shape[:2]
    nc = -(-S // Q)
    t = t.to(acc)
    if nc * Q != S:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * Q - S))
    return t.reshape(B, nc, Q, *t.shape[2:]).transpose(2, 3)


def _unchunked(t: torch.Tensor, S: int, dtype: torch.dtype) -> torch.Tensor:
    """``_chunked``'s inverse: (B, nc, K, Q, ...) -> (B, S, K, ...)."""
    B, nc, K, Q = t.shape[:4]
    t = t.transpose(2, 3).reshape(B, nc * Q, K, *t.shape[4:])
    return t[:, :S].to(dtype)


def ssd_scan_backward(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor,
                      head_mask: Optional[torch.Tensor],
                      dy: Optional[torch.Tensor],
                      dstate: Optional[torch.Tensor], chunk: int = 256
                      ) -> Tuple[torch.Tensor, ...]:
    """(dxh, ddt, dA, dBm, dCm) of ``ssd_scan`` at its operands for the
    gradients ``dy`` of y and ``dstate`` of the final state (either None
    for zeros), by hand in the chunked form at ``min(chunk, S)``; fp32
    math (float64 for float64 operands), each cast to its operand's dtype.

    Per chunk, with ``cs`` the cumulative sum of dt·A, ``L = exp(segsum)``
    and ``W = (C·Bᵀ)∘L``: y = W·(dt∘x) + exp(cs)∘(C·prevᵀ), the chunk's
    state Σ_j dt_j·exp(cs_end − cs_j)·x_j⊗B_j, carried as prev·exp(cs_end)
    + state. The backward takes ``dy·head_mask``, then the products of the
    diagonal blocks (dx, ddt and dC, dB from ``W`` and ``dW``), the
    gradient of each carried state by a reverse pass over the chunks from
    ``dstate``, the chunk-state products, and the exponents' gradient
    ``dcs``, whose reverse cumulative sum gives d(dt·A). B and C gradients
    are summed over each group's heads. Every product is a batched
    ``matmul`` over (batch, chunk, head)."""
    acc = torch.promote_types(xh.dtype, torch.float32)
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = max(1, min(chunk, S))
    nc = -(-S // Q)
    rep = H // G
    x = _chunked(xh, Q, acc)                          # (B,nc,H,Q,P)
    Bc = _chunked(Bm, Q, acc).unsqueeze(3)            # (B,nc,G,1,Q,N)
    Cc = _chunked(Cm, Q, acc).unsqueeze(3)
    dtc = _chunked(dt, Q, acc)                        # (B,nc,H,Q)
    if dy is None:
        g = torch.zeros_like(x)
    else:
        if head_mask is not None:
            dy = dy.to(acc) * head_mask.to(acc)[:, None]
        g = _chunked(dy, Q, acc)                      # (B,nc,H,Q,P)

    def grouped(t):      # (B,nc,H,...) -> (B,nc,G,rep,...)
        return t.reshape(Bsz, nc, G, rep, *t.shape[3:])

    def heads(t):        # (B,nc,G,rep,...) -> (B,nc,H,...)
        return t.reshape(Bsz, nc, H, *t.shape[4:])

    Af = A.to(acc)[:, None]
    cs = torch.cumsum(dtc * Af, -1)                   # (B,nc,H,Q)
    L = torch.exp(_segsum(dtc * Af))                  # (B,nc,H,Q,Q)
    W = grouped(L) * (Cc @ Bc.transpose(-1, -2))      # (B,nc,G,rep,Q,Q)
    # the diagonal blocks: y_i = Σ_j W_ij dt_j x_j
    dW = (g @ x.transpose(-1, -2)).mul_(dtc[..., None, :])
    u = heads(W.transpose(-1, -2) @ grouped(g))       # Wᵀ·dy (B,nc,H,Q,P)
    dx = dtc[..., None] * u
    ddt = (x * u).sum(-1)
    del u
    M = grouped(dW) * W                               # dL∘L
    dcs = heads(M.sum(-1) - M.sum(-2))                # (B,nc,H,Q)
    del M, W
    dCB = (grouped(dW) * grouped(L)).sum(3)           # (B,nc,G,Q,Q)
    del dW, L
    dC = dCB @ Bc[:, :, :, 0]
    dB = dCB.transpose(-1, -2) @ Cc[:, :, :, 0]
    del dCB
    # the chunks' states and the states carried into them
    decay = torch.exp(cs[..., -1:] - cs)              # (B,nc,H,Q)
    w = dtc * decay
    xw = x * w[..., None]
    states = heads(grouped(xw).transpose(-1, -2) @ Bc)   # (B,nc,H,P,N)
    chunk_decay = torch.exp(cs[..., -1])              # (B,nc,H)
    prev = torch.empty_like(states)
    s = torch.zeros_like(states[:, 0])
    for c in range(nc):
        prev[:, c] = s
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    del states
    # the off-diagonal term: y_i += exp(cs_i)·(C_i·prevᵀ)
    eg = torch.exp(cs)[..., None] * g                 # (B,nc,H,Q,P)
    dC = dC + (grouped(eg) @ grouped(prev)).sum(3)
    dcs += (eg * heads(Cc @ grouped(prev).transpose(-1, -2))).sum(-1)
    dprev = heads(grouped(eg).transpose(-1, -2) @ Cc)    # (B,nc,H,P,N)
    del eg
    # the reverse state pass: dS[c] is the gradient of chunk c's state
    dS = torch.empty_like(prev)
    gs = torch.zeros_like(prev[:, 0]) if dstate is None else dstate.to(acc)
    for c in reversed(range(nc)):
        dS[:, c] = gs
        dcs[:, c, :, -1] += (gs * prev[:, c]).sum((-1, -2)) * \
            chunk_decay[:, c]
        gs = gs * chunk_decay[:, c, :, None, None] + dprev[:, c]
    del prev, dprev
    # the chunk-state products
    SB = heads(Bc @ grouped(dS).transpose(-1, -2))    # (B,nc,H,Q,P)
    dx += w[..., None] * SB
    xSB = (x * SB).sum(-1)
    del SB
    ddt += decay * xSB
    v = w * xSB
    dcs -= v
    dcs[..., -1] += v.sum(-1)
    dB = dB + (grouped(xw) @ grouped(dS)).sum(3)
    del dS, xw
    # exponents: cs = cumsum(dt·A), so d(dt·A) is dcs summed from the end
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt += da * Af
    dA = (da * dtc).sum((0, 1, 3))
    return (_unchunked(dx, S, xh.dtype), _unchunked(ddt, S, dt.dtype),
            dA.to(A.dtype), _unchunked(dB, S, Bm.dtype),
            _unchunked(dC, S, Cm.dtype))


class _SSDScan(torch.autograd.Function):
    """``ssd_scan`` as an autograd node: the forward launches the kernels
    (the plain version on the CPU) and keeps the caller's operands, not
    the copies ``_kernel_layout`` may make; the backward is
    ``ssd_scan_backward``. A gradient of an output autograd does not
    reach (the final state, in training) stays None. ``head_mask`` gets
    none: pruning masks are constants."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, head_mask, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, dt, A, Bm, Cm, head_mask)
        ctx.chunk = chunk
        return _ssd_scan(xh, dt, A, Bm, Cm, head_mask, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        xh, dt, A, Bm, Cm, head_mask = ctx.saved_tensors
        with exact_fp32():
            grads = ssd_scan_backward(xh, dt, A, Bm, Cm, head_mask, dy,
                                      dstate, ctx.chunk)
        return (*grads, None, None)


def _ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor,
              head_mask: Optional[torch.Tensor],
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving path: the kernels on card tensors, the plain version on
    CPU ones."""
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, dt, A, Bm, Cm, head_mask, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    B, S, H, P = xh.shape
    N = Bm.shape[3]
    if head_mask is None:
        head_mask = torch.ones((H,), dtype=torch.float32, device=xh.device)
    _check_cuda_operands(xh, dt, A, Bm, Cm, head_mask)
    xh, Bm, Cm = _kernel_layout(xh, Bm, Cm)
    dt, A, head_mask = dt.contiguous(), A.contiguous(), head_mask.contiguous()
    y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    if B == 0 or H == 0:
        return y, state
    ws_cs = ws_st = None
    if xh.dtype == torch.bfloat16:
        nc = -(-S // CHUNK)
        ws_cs = torch.empty((B, H, nc, CHUNK), dtype=torch.float32,
                            device=xh.device)
        ws_st = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                            device=xh.device)
    build.launch("ssd_scan", _ENTRIES[xh.dtype], _ARGTYPES, xh.device,
                 xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), head_mask.data_ptr(), y.data_ptr(),
                 state.data_ptr(),
                 None if ws_cs is None else ws_cs.data_ptr(),
                 None if ws_st is None else ws_st.data_ptr(),
                 B, S, H, Bm.shape[2], P, N,
                 xh.stride(0), xh.stride(1), Bm.stride(0), Bm.stride(1),
                 dt.stride(0), dt.stride(1))
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
