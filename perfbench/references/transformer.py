"""Plain fp32 forward of a dense GQA decoder (Qwen2), in PyTorch ops.

Written from the published architecture: token embedding, per layer a
pre-RMSNorm, Q/K/V projections with biases, rotary embeddings (rotate
half, theta from the configuration), causal grouped-query softmax
attention, the output projection and a residual, a pre-RMSNorm SiLU-gated
FFN and a residual; a final RMSNorm and an untied head. The pruning masks
are the deployment's: a pruned head's attention output and a pruned FFN
channel's up and gate outputs are zero, so only the kept heads (and the
key-value groups they read) and the kept channels are computed.

Every product runs in float32 with TF32 off, layer by layer, each
layer's weights cast from the served bf16 just before use; attention in
blocks of queries so that the scores fit. ``cast`` rounds each weight
matrix first (``fp8_weights``: the control in the next precision below
bf16). It imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

#: queries a block of the attention's scores
Q_BLOCK = 1024


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` (in, out) rounded to float8 e4m3 with one scale per output
    column (its largest magnitude onto 448), back in float32."""
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, heads, D) rotated by positions ``pos`` (T,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, kv_of: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention; q (B, T, H, D), k and v (B, T, G, D),
    query head i reading key-value group ``kv_of[i]``."""
    B, T, H, D = q.shape
    k = k.index_select(2, kv_of).transpose(1, 2)           # (B, H, T, D)
    v = v.index_select(2, kv_of).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    for lo in range(0, T, Q_BLOCK):
        hi = min(T, lo + Q_BLOCK)
        s = (q[:, :, lo:hi] @ k[:, :, :hi].transpose(-1, -2)) * scale
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        ki = torch.arange(hi, device=q.device)[None]
        s = s.masked_fill(ki > qi, float("-inf"))
        out[:, :, lo:hi] = torch.softmax(s, -1) @ v[:, :, :hi]
    return out.transpose(1, 2)


def logits(w: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor],
           m: dict, tokens: torch.Tensor, at: Sequence[int],
           cast: Optional[Callable] = None) -> torch.Tensor:
    """fp32 logits (B, len(at), V) at positions ``at`` of ``tokens`` (B, T)
    under causal attention over all T positions."""
    cast = cast or (lambda t: t)
    B, T = tokens.shape
    rep, D = m["H"] // m["Hkv"], m["D"]
    dev = tokens.device
    pos = torch.arange(T, device=dev)
    cols = lambda units: (units[:, None] * D  # noqa: E731
                          + torch.arange(D, device=dev)).reshape(-1)
    with full_fp32(), torch.no_grad():
        x = w["embed"][tokens].float()
        for l in range(m["L"]):
            mat = lambda k: cast(w[k][l].float())  # noqa: E731
            heads = masks["head_mask"][l].nonzero()[:, 0]
            groups, kv_of = torch.unique(heads // rep, return_inverse=True)
            qc, kc = cols(heads), cols(groups)
            h = _rmsnorm(x, w["ln1"][l], m["eps"])
            q, k, v = (h @ mat("wq")[:, qc], h @ mat("wk")[:, kc],
                       h @ mat("wv")[:, kc])
            if m["bias"]:
                q = q + w["bq"][l][qc].float()
                k = k + w["bk"][l][kc].float()
                v = v + w["bv"][l][kc].float()
            q = _rope(q.view(B, T, len(heads), D), pos, m["theta"])
            k = _rope(k.view(B, T, len(groups), D), pos, m["theta"])
            a = _attention(q, k, v.view(B, T, len(groups), D), kv_of,
                           D ** -0.5)
            x = x + a.reshape(B, T, len(qc)) @ mat("wo")[qc]
            h = _rmsnorm(x, w["ln2"][l], m["eps"])
            fc = masks["ffn_mask"][l].nonzero()[:, 0]
            g = torch.nn.functional.silu(h @ mat("w_up")[:, fc]) \
                * (h @ mat("w_gate")[:, fc])
            del h
            x = x + g @ mat("w_down")[fc]
            del g
        idx = torch.as_tensor(list(at), device=tokens.device)
        x = _rmsnorm(x[:, idx], w["final_norm"], m["eps"])
        return x @ cast(w["lm_head"].float())


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each chosen token's
    logit lies: ref (..., V) fp32, chosen (...) token ids."""
    return ref.max(-1).values - ref.gather(-1, chosen[..., None])[..., 0]


def served_gaps(w, masks, m, tokens: torch.Tensor, at: Sequence[int],
                served: torch.Tensor, control=None) -> torch.Tensor:
    """The gap under the fp32 reference at each position ``at`` of the
    token served there; with ``control="precision"``, of the token the
    fp8-weight reference puts first instead (the control)."""
    best = logits(w, masks, m, tokens, at)
    if control == "precision":
        served = logits(w, masks, m, tokens, at,
                        cast=fp8_weights).argmax(-1)
    return gaps(best, served)
