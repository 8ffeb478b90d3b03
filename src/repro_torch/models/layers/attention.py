"""Attention blocks: GQA (with optional QKV bias / sliding window /
bidirectional). MLA and the head-atomic chunked path come with the MoE
slice.

Prefill (``gqa_forward``) goes through the flash-attention wrapper
(``kernels.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU or with ``backend="ref"``). Decode (``gqa_decode``)
takes one new token per sequence against the KV cache; the reference has
no kernel there, so it is plain PyTorch. Pruning hook: an optional
``head_mask`` (num_heads,) multiplies the attention output per head.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_gqa_params(gen: torch.Generator, cfg, dtype: torch.dtype,
                    device: torch.device):
    p = {
        "wq": _dense_init(gen, (cfg.d_model, cfg.q_dim), dtype, device),
        "wk": _dense_init(gen, (cfg.d_model, cfg.kv_dim), dtype, device),
        "wv": _dense_init(gen, (cfg.d_model, cfg.kv_dim), dtype, device),
        "wo": _dense_init(gen, (cfg.q_dim, cfg.d_model), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# masks and plain attention
# ---------------------------------------------------------------------------
def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) boolean allow-mask from position vectors."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    # sentinel (>= 2**29) marks padded KV slots — always excluded
    ok = (k_pos < 2 ** 29)[..., None, :] & torch.ones(
        d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return ok


def naive_attention(q, k, v, mask, scale):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D); mask (B,Sq,Sk) or (Sq,Sk) boolean."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask.dim() == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len, q_pos, window, scale):
    """Single-step decode: q (B,1,H,D) against (B,Smax,Hkv,D) cache.

    ``valid_len`` (B,) — number of filled cache slots; positions are
    0..valid_len-1 (or a rolling window layout handled by the caller)."""
    B, _, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    qg = (q.to(torch.float32) * scale).reshape(B, Hkv, group, D)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(torch.float32))
    kpos = torch.arange(Smax, device=q.device)[None]
    ok = kpos < valid_len[:, None]
    if window is not None:
        ok &= kpos > (q_pos[:, None] - window)
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, Smax, Hkv, D)
    v: torch.Tensor


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _qkv(params, cfg, x, angles, S):
    B = x.shape[0]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def gqa_forward(params, cfg, x, angles, *, head_mask=None,
                backend: str = "auto"):
    """Full-sequence forward (prefill). Returns (out, (k, v)). The
    attention is the flash kernel's wrapper (``"auto"``) or its plain
    version (``"ref"``)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, angles, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    attend = attention_ref if backend == "ref" else flash_attention
    out = attend(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                 scale=scale)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    return out.reshape(B, S, cfg.q_dim) @ params["wo"], (k, v)


def gqa_decode(params, cfg, x, angles, cache: KVCache, pos, *,
               head_mask=None):
    """One-token decode. x (B,1,d_model); pos (B,) absolute position.

    For sliding-window configs the cache is a rolling buffer of size
    min(Smax, window): slot = pos % cache_len. Unlike the reference, which
    returns new cache arrays, this writes the new key and value into
    ``cache``'s tensors in place (one slot per sequence) and returns the
    same tensors: a decode step copies no cache."""
    B = x.shape[0]
    q, k, v = _qkv(params, cfg, x, angles, 1)
    cache_len = cache.k.shape[1]
    slot = (pos % cache_len).long()
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k[:, 0]
    cache.v[rows, slot] = v[:, 0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if cfg.sliding_window is not None and cache_len <= cfg.sliding_window:
        # rolling buffer: every slot written within the window is valid
        valid = torch.clamp(pos + 1, max=cache_len)
        window = None   # rolling buffer already enforces the window
    else:
        valid = pos + 1
        window = cfg.sliding_window
    out = decode_attention(q, cache.k, cache.v, valid, pos, window, scale)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    out = out.reshape(B, 1, cfg.q_dim) @ params["wo"]
    return out, cache
