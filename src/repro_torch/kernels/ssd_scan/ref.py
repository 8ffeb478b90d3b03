"""Plain PyTorch version of the chunked SSD scan (the reference's
``models/layers/ssm.py:_segsum``/``ssd_chunked`` and the head-mask epilogue
of its ``kernels/ssd_scan`` wrapper): the CPU path, ``backend="ref"``, and
the yardstick the CUDA kernel is held against on the card.

fp32 math throughout (float64 for float64 operands, which gradient
checks use): per chunk of ``chunk`` steps the intra-chunk
(attention-like) products under the decay matrix ``L = exp(segsum)``, the
chunk-final states, then the inter-chunk recurrence (the reference's
``lax.scan``, here a Python loop over chunks) and the carried-in states seen
through each step's decay.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum_{j < m <= i} x[m]; -inf above the diagonal (so that
    ``exp`` selects 0 there and never multiplies an overflow by 0)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, float("-inf"))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (fp32 math; float64 for float64 operands).

    xh (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; Bm/Cm
    (B,S,G,N) shared by the H/G heads of each group. Returns (y (B,S,H,P)
    float32, final_state (B,H,P,N) float32)."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    rep = H // G
    acc = torch.promote_types(xh.dtype, torch.float32)
    xc = xh.reshape(Bsz, nc, chunk, H, P).to(acc)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(acc)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, 3).to(acc)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, 3).to(acc)

    dA = dtc * A.to(acc)                                  # (B,nc,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)
    # intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))        # (B,nc,H,Q,Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", CB * L, dtc, xc)
    # chunk-final states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchpn",
                          Bc, dtc, decay_to_end, xc)
    # inter-chunk recurrence: prev[c] is the state carried into chunk c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (B,nc,H)
    s = torch.zeros((Bsz, H, P, N), dtype=acc, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                    # (B,nc,H,P,N)
    # off-diagonal contribution: carry-in state seen through per-step decay
    state_decay = torch.exp(dA_cs)                        # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                         Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)
    return y[:, :S], s


def ssd_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 head_mask: Optional[torch.Tensor] = None,
                 chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract: ``ssd_chunked`` at ``min(chunk, S)``, y
    multiplied by ``head_mask`` (H,) and returned in xh's dtype; the final
    state (B,H,P,N) float32 (float64 for float64 operands) for every head,
    pruned heads included, unmasked."""
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, max(1, min(chunk, xh.shape[1])))
    if head_mask is not None:
        y = y * head_mask.to(y.dtype)[None, None, :, None]
    return y.to(xh.dtype), state
