"""Attention blocks: GQA (with optional QKV bias / sliding window /
bidirectional), and DeepSeek-style MLA with its compressed latent KV
cache.

GQA prefill (``gqa_forward``) goes through the flash-attention wrapper
(``kernels.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU); with ``backend="ref"`` it takes the reference's
kernel-off path: the plain version up to ``cfg.naive_attn_max`` tokens,
``chunked_attention`` above. MLA prefill
(``mla_forward``) never reaches that kernel, as in the reference: it runs
the materialising ``naive_attention`` up to ``cfg.naive_attn_max`` tokens
and ``chunked_attention`` (an online-softmax loop over KV blocks) above
it, both plain PyTorch; its two latent norms (``q_norm``, ``kv_norm``) go
through the rmsnorm wrapper. Decode (``gqa_decode``, ``mla_decode``)
takes one new token per sequence against the cache; the reference has no
kernel there, so it is plain PyTorch. The head-atomic chunked path
(``chunked_attention_ha``), a sharding lever, is the plain branch's
choice above ``cfg.naive_attn_max`` tokens when ``cfg.attn_head_atomic``
is set (no registry config sets it), as in the reference; its
``maybe_constrain`` calls are the identity outside a mesh.
Pruning hook: an optional ``head_mask`` (num_heads,) multiplies the
attention output per head.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers.init import normal, slot
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.constraints import data_axes_spec, maybe_constrain
from repro_torch.sharding.context_parallel import partial_softmax
from repro_torch.sharding.specs import P

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None, out=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return normal(gen, shape, dtype, device, mul=scale, out=out)


def init_gqa_params(gen: torch.Generator, cfg, dtype: torch.dtype,
                    device: torch.device, out=None):
    """Weights normal x 1/sqrt(fan_in) from ``gen``, each into its slot
    of ``out`` where given (``layers.init``); zero QKV biases."""
    def draw(name, shape):
        return _dense_init(gen, shape, dtype, device, out=slot(out, name))
    p = {
        "wq": draw("wq", (cfg.d_model, cfg.q_dim)),
        "wk": draw("wk", (cfg.d_model, cfg.kv_dim)),
        "wv": draw("wv", (cfg.d_model, cfg.kv_dim)),
        "wo": draw("wo", (cfg.q_dim, cfg.d_model)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
    return p


def init_mla_params(gen: torch.Generator, cfg, dtype: torch.dtype,
                    device: torch.device, out=None):
    """The reference's MLA tree, drawn in its order: the query's low-rank
    down- and up-projections around ``q_norm``, the joint KV
    down-projection (latent plus the shared rope key) and ``kv_norm``, the
    latent's per-head key and value up-projections, and ``wo``; weights
    normal x 1/sqrt(fan_in), unit norm scales."""
    m = cfg.mla
    H = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def draw(name, shape):
        return _dense_init(gen, shape, dtype, device, out=slot(out, name))

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)
    return {
        "w_dq": draw("w_dq", (cfg.d_model, m.q_lora_rank)),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": draw("w_uq", (m.q_lora_rank, H * qk_head)),
        "w_dkv": draw("w_dkv", (cfg.d_model,
                                m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": ones(m.kv_lora_rank),
        "w_uk": draw("w_uk", (m.kv_lora_rank, H * m.qk_nope_head_dim)),
        "w_uv": draw("w_uv", (m.kv_lora_rank, H * m.v_head_dim)),
        "wo": draw("wo", (H * m.v_head_dim, cfg.d_model)),
    }


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


def decode_attention(q, k_cache, v_cache, valid_len, q_pos, window, scale,
                     partial_sum=None, k_offset: int = 0, combine=None):
    """Single-step decode: q (B,1,H,D) against (B,Smax,Hkv,D) cache.

    ``valid_len`` (B,) — number of filled cache slots; positions are
    0..valid_len-1 (or a rolling window layout handled by the caller).
    ``partial_sum``, where given, sums the float32 scores over the ranks
    that each hold a part of the head dim (D here is that part).
    ``combine``, where given, joins the partial softmaxes of the ranks
    that each hold a block of the slots (``SeqSplit.combine``; the cache
    here is the block starting at slot ``k_offset``)."""
    B, _, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    qg = (q.to(torch.float32) * scale).reshape(B, Hkv, group, D)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(torch.float32))
    if partial_sum is not None:
        logits = partial_sum(logits)
    kpos = torch.arange(k_offset, k_offset + Smax, device=q.device)[None]
    ok = kpos < valid_len[:, None]
    if window is not None:
        ok &= kpos > (q_pos[:, None] - window)
    if combine is not None:
        p, m, l = partial_softmax(logits, ok[:, None, None])
        acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32))
        return combine(m, l, acc).reshape(B, 1, H, D).to(q.dtype)
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, causal: bool,
                      window: Optional[int], scale: float,
                      block_kv: int = 1024):
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    an online softmax, the reference's ``chunked_attention``.

    q (B,Sq,H,D); k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv); q_pos (B,Sq), k_pos
    (B,Sk). K and V are padded to whole blocks of ``block_kv``, the padded
    positions marked with the 2**30 sentinel that ``_band_mask`` excludes.
    The running max, denominator and accumulator are float32; every block
    is computed, masked or not, as in the reference. Memory: one block's
    (B, H, Sq, block_kv) float32 logits at a time, masked and
    exponentiated in place."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    group = H // Hkv
    f32 = torch.float32
    nblk = -(-Sk // block_kv)
    pad = nblk * block_kv - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
    qg = (q.to(f32) * scale).reshape(B, Sq, Hkv, group, D)
    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, group, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, Dv), dtype=f32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, blk].to(f32))
        ok = _band_mask(q_pos[:, None, None], k_pos[:, None, None, blk],
                        causal, window)                 # (B,1,1,Sq,block)
        logits = logits.masked_fill_(~ok, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = logits.sub_(m_new[..., None]).exp_()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, blk].to(f32))
        m = m_new
        del logits, p       # free the block's logits before the next one's
    out = acc / l.clamp_min(1e-37)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def chunked_attention_ha(q, k, v, q_pos, k_pos, causal: bool,
                         window: Optional[int], scale: float,
                         block_kv: int = 1024):
    """The head-atomic variant of ``chunked_attention`` (the reference's
    ``chunked_attention_ha``): K and V repeated to all H query heads
    instead of H reshaped into (Hkv, group), so the (B, H, Sq, block)
    logits can shard H over "model" even when that axis divides neither
    Hkv nor the group (28 heads on a 16-way axis). The same fp32 online
    softmax over KV blocks padded to whole blocks (padded keys at the
    2**30 sentinel), with ``maybe_constrain`` on K, V and each block's
    logits."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // Hkv
    f32 = torch.float32
    dspec = data_axes_spec()
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    k = maybe_constrain(k, P(dspec, None, "model", None))
    v = maybe_constrain(v, P(dspec, None, "model", None))
    nblk = -(-Sk // block_kv)
    pad = nblk * block_kv - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
    qh = q.to(f32) * scale
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=f32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, k[:, blk].to(f32))
        logits = maybe_constrain(logits, P(dspec, "model", None, None))
        ok = _band_mask(q_pos[:, None], k_pos[:, None, blk], causal,
                        window)                          # (B,1,Sq,block)
        logits = logits.masked_fill_(~ok, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = logits.sub_(m_new[..., None]).exp_()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, blk].to(f32))
        m = m_new
        del logits, p
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


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
    """q (B, S, heads, D), k and v (B, S, KV heads, D), the head counts
    those of the projections' columns (a tensor-parallel rank's block)."""
    B = x.shape[0]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def gqa_forward(params, cfg, x, angles, *, head_mask=None,
                backend: str = "auto", tp=None):
    """Full-sequence forward (prefill). Returns (out, (k, v)). The
    attention is the flash kernel's wrapper (``"auto"``) or, on the plain
    branch (``"ref"``), what the reference runs with its kernels off: the
    kernel's plain version up to ``naive_attn_max`` tokens, and above it
    ``chunked_attention`` (``chunked_attention_ha`` for a config with
    ``attn_head_atomic``), one KV block's scores at a time. With ``tp``
    (a ``sharding.tensor_parallel.TensorParallel``) ``params`` hold the
    rank's head block: the attention runs on its heads (KV heads repeated
    where the block crosses KV groups unevenly), ``head_mask`` is its
    heads', and the out product's partial sum is reduced over "model";
    (k, v) are the KV heads the rank computed. Where ``tp.seq`` splits
    the positions over the data axes (``sharding.context_parallel``), x is
    this rank's block of them: K and V are all-gathered, cut to the keys
    the block's queries can see, and attended at the block's offset;
    (k, v) are then the whole sequence's."""
    B, S, _ = x.shape
    seq = None if tp is None else tp.seq_tokens
    if tp is not None:
        x = tp.copy_in(x)
    q, k, v = _qkv(params, cfg, x, angles, S)
    offset, k0, S_all = 0, 0, S
    ka, va = k, v
    if seq is not None:
        k, v = seq.gather(torch.stack([k, v]), 2).unbind(0)
        S_all = k.shape[1]
        offset = seq.block(S)[0]
        k0, k1 = seq.keys(offset, S, cfg.causal, cfg.sliding_window)
        ka, va = k[:, k0:k1], v[:, k0:k1]
    if tp is not None:
        ka, va = tp.kv_for_q(ka, va)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if backend == "ref" and S_all > cfg.naive_attn_max:
        qpos = torch.arange(offset, offset + S, device=x.device)[None] \
            .expand(B, S)
        kpos = torch.arange(k0, k0 + ka.shape[1], device=x.device)[None] \
            .expand(B, ka.shape[1])
        if cfg.attn_head_atomic:
            q = maybe_constrain(q, P(data_axes_spec(), None, "model", None))
            out = chunked_attention_ha(q, ka, va, qpos, kpos, cfg.causal,
                                       cfg.sliding_window, scale)
        else:
            out = chunked_attention(q, ka, va, qpos, kpos, cfg.causal,
                                    cfg.sliding_window, scale)
    else:
        attend = attention_ref if backend == "ref" else flash_attention
        extra = {} if seq is None else {"q_offset": offset - k0}
        out = attend(q, ka, va, causal=cfg.causal,
                     window=cfg.sliding_window, scale=scale, **extra)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    out = out.reshape(B, S, -1) @ params["wo"]
    return (out if tp is None else tp.reduce(out)), (k, v)


def gqa_decode(params, cfg, x, angles, cache: KVCache, pos, *,
               head_mask=None, tp=None):
    """One-token decode. x (B,1,d_model); pos (B,) absolute position.

    For sliding-window configs the cache is a rolling buffer of size
    min(Smax, window): slot = pos % cache_len. Unlike the reference, which
    returns new cache arrays, this writes the new key and value into
    ``cache``'s tensors in place (one slot per sequence) and returns the
    same tensors: a decode step copies no cache. With ``tp`` the cache is
    the rank's shard of the layer's (``TensorParallel.decode_attention``
    writes it and attends the rank's heads) and the out product's partial
    sum is reduced over "model". Where ``tp.seq`` splits the sequence over
    the data axes, the slot and the window are taken in the global slots
    of its layout (``tp.seq.kv``)."""
    B = x.shape[0]
    if tp is not None:
        x = tp.copy_in(x)
    q, k, v = _qkv(params, cfg, x, angles, 1)
    seq = None if tp is None else tp.seq
    cache_len = cache.k.shape[1] if seq is None else seq.kv.count
    slot = (pos % cache_len).long()
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if cfg.sliding_window is not None and cache_len <= cfg.sliding_window:
        # rolling buffer: every slot written within the window is valid
        valid = torch.clamp(pos + 1, max=cache_len)
        window = None   # rolling buffer already enforces the window
    else:
        valid = pos + 1
        window = cfg.sliding_window
    if tp is None:
        rows = torch.arange(B, device=x.device)
        cache.k[rows, slot] = k[:, 0]
        cache.v[rows, slot] = v[:, 0]
        out = decode_attention(q, cache.k, cache.v, valid, pos, window, scale)
    else:
        out = tp.decode_attention(q, cache, k[:, 0], v[:, 0], slot, valid,
                                  pos, window, scale)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return (out if tp is None else tp.reduce(out)), cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3). Prefill materialises per-head K/V; decode uses
# the weight-absorbed latent form, so the cache stays (kv_lora_rank +
# rope_dim) values a token whatever the head count.
# ---------------------------------------------------------------------------
class MLACache(NamedTuple):
    ckv: torch.Tensor        # (B, Smax, kv_lora_rank)
    krope: torch.Tensor      # (B, Smax, qk_rope_head_dim)


def init_mla_cache(batch: int, max_len: int, mla, dtype: torch.dtype,
                   device: torch.device) -> MLACache:
    return MLACache(
        torch.zeros((batch, max_len, mla.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, mla.qk_rope_head_dim), dtype=dtype,
                    device=device))


def _mla_latents(params, cfg, x, angles, backend: str):
    """(q_lat, ckv, k_rope): the query's normed low-rank latent, the
    normed KV latent and the one rotary key all heads share, the parts
    of MLA a tensor-parallel rank computes whole. ``kv_norm`` normalises
    a strided slice of the joint down-projection, which the rmsnorm
    wrapper makes contiguous."""
    m = cfg.mla
    q_lat = rmsnorm(x @ params["w_dq"], params["q_norm"], cfg.norm_eps,
                    backend=backend)
    dkv = x @ params["w_dkv"]
    ckv = rmsnorm(dkv[..., :m.kv_lora_rank], params["kv_norm"],
                  cfg.norm_eps, backend=backend)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], angles)[:, :, 0]
    return q_lat, ckv, k_rope


def _mla_queries(params, cfg, q_lat, angles):
    """(q_nope, q_rope) of the heads of ``w_uq``'s columns (a
    tensor-parallel rank's block): each head split into its position-free
    and rotary parts."""
    m = cfg.mla
    B, S, _ = q_lat.shape
    q = (q_lat @ params["w_uq"]).reshape(
        B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, angles)


def mla_forward(params, cfg, x, angles, *, head_mask=None,
                backend: str = "auto", tp=None):
    """Prefill path: per-head K/V materialised from the latent, the one
    rotary key broadcast to all H heads; naive attention up to
    ``cfg.naive_attn_max`` tokens, chunked above. Returns (out, (ckv,
    k_rope)), what the cache keeps. With ``tp`` (a
    ``sharding.tensor_parallel.TensorParallel``) the latents are computed
    whole and enter the rank's heads through ``copy_in`` (the query
    latent, the KV latent and the rotary key: each rank's heads read all
    of them); ``params`` hold the rank's columns of ``w_uq``, ``w_uk``,
    ``w_uv`` and rows of ``wo``, ``head_mask`` its heads'; the out
    product's partial sum is reduced over "model"; (ckv, k_rope) are
    whole. Where ``tp.seq`` splits the positions over the data axes, x is
    this rank's block: the latents (not the expanded K and V) are
    all-gathered, cut to the keys the block's queries can see and
    expanded there; (ckv, k_rope) are then the whole sequence's."""
    m = cfg.mla
    B, S, _ = x.shape
    seq = None if tp is None else tp.seq_tokens
    q_lat, ckv, k_rope = _mla_latents(params, cfg, x, angles, backend)
    offset, k0, S_all = 0, 0, S
    ck, kr = ckv, k_rope
    if seq is not None:
        ckv, k_rope = seq.gather(torch.cat([ckv, k_rope], -1), 1).split(
            [m.kv_lora_rank, m.qk_rope_head_dim], -1)
        S_all = ckv.shape[1]
        offset = seq.block(S)[0]
        k0, k1 = seq.keys(offset, S, cfg.causal, None)
        ck, kr = ckv[:, k0:k1], k_rope[:, k0:k1]
    qc, cc, kc = ((q_lat, ck, kr) if tp is None else
                  (tp.copy_in(q_lat), tp.copy_in(ck), tp.copy_in(kr)))
    q_nope, q_rope = _mla_queries(params, cfg, qc, angles)
    H = q_nope.shape[2]
    Sk = cc.shape[1]
    k_nope = (cc @ params["w_uk"]).reshape(B, Sk, H, m.qk_nope_head_dim)
    vv = (cc @ params["w_uv"]).reshape(B, Sk, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, kc[:, :, None].expand(
        B, Sk, H, m.qk_rope_head_dim)], -1)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    qpos = torch.arange(offset, offset + S, device=x.device)
    kpos = torch.arange(k0, k0 + Sk, device=x.device)
    if S_all > cfg.naive_attn_max:
        out = chunked_attention(q, k, vv, qpos[None].expand(B, S),
                                kpos[None].expand(B, Sk), cfg.causal, None,
                                scale)
    else:
        mask = _band_mask(qpos, kpos, cfg.causal, None)
        out = naive_attention(q, k, vv, mask, scale)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    out = out.reshape(B, S, H * m.v_head_dim) @ params["wo"]
    return (out if tp is None else tp.reduce(out)), (ckv, k_rope)


def latent_scores(q_lat, q_rope, ckv, krope, pos, scale: float,
                  partial_sum=None, k_offset: Optional[int] = None):
    """The absorbed decode's attention weights (B, heads, Smax), float32:
    ``q_lat`` (B, heads, r) against ``ckv`` (B, Smax, r) plus ``q_rope``
    against ``krope``, times ``scale``, slots past ``pos`` masked, a
    softmax. ``partial_sum``, where given, sums the scores over the ranks
    that each hold a part of the latent dims (r here is that part). With
    ``k_offset`` (the cache here the block of the slots from there, a
    sequence split's) the softmax is this block's part, ``(p, m, l)`` of
    ``partial_softmax``, for ``SeqSplit.combine``."""
    f32 = torch.float32
    s_lat = torch.einsum("bhr,bkr->bhk", q_lat, ckv.to(f32))
    s_rope = torch.einsum("bhd,bkd->bhk", q_rope, krope.to(f32))
    logits = s_lat + s_rope
    if partial_sum is not None:
        logits = partial_sum(logits)
    logits = logits * scale
    at = 0 if k_offset is None else k_offset
    ok = torch.arange(at, at + ckv.shape[1], device=ckv.device)[None] < (
        pos[:, None] + 1)
    if k_offset is not None:
        return partial_softmax(logits, ok[:, None])
    logits = torch.where(ok[:, None], logits, NEG_INF)
    return torch.softmax(logits, dim=-1)


def latent_attention(q_lat, q_rope, cache: MLACache, pos, scale: float,
                     seq=None) -> torch.Tensor:
    """The absorbed decode's latent output o_lat (B, heads, r), float32:
    ``latent_scores`` of the heads' queries against the whole latent cache
    of one layer (the step's slot already written), times ``cache.ckv``.
    Where ``seq`` (a ``SeqSplit``) splits the latent slots
    (``seq.latent``), the cache is this rank's block of them and the
    ranks' partial softmaxes are combined."""
    f32 = torch.float32
    if seq is None or not seq.latent.split:
        probs = latent_scores(q_lat, q_rope, cache.ckv, cache.krope, pos,
                              scale)
        return torch.einsum("bhk,bkr->bhr", probs, cache.ckv.to(f32))
    p, m, l = latent_scores(q_lat, q_rope, cache.ckv, cache.krope, pos,
                            scale, k_offset=seq.latent.lo)
    return seq.combine(m, l, torch.einsum("bhk,bkr->bhr", p,
                                          cache.ckv.to(f32)))


def mla_decode(params, cfg, x, angles, cache: MLACache, pos, *,
               head_mask=None, backend: str = "auto", tp=None):
    """Absorbed decode: scores and values in the latent space, per head,

        scores = (q_nope W_uk^T) . ckv + q_rope . k_rope
        out    = (softmax(scores) @ ckv) W_uv,

    in float32 (``w_uk`` absorbed and ``w_uv`` applied in float32, the head
    mask on the float32 output), cast to x's dtype only before ``wo``. The
    new latent and rotary key are written into ``cache``'s tensors in
    place at slot ``pos % cache_len``, as ``gqa_decode`` does; the valid
    slots are ``0..pos`` (MLA has no window). With ``tp`` the cache is the
    rank's shard of the layer's latent cache, ``params`` the rank's heads
    (``mla_forward``), and the scores go where the cache lies
    (``TensorParallel.latent_attention``); the out product's partial sum
    is reduced over "model". Where ``tp.seq`` splits the sequence over the
    data axes, the slot is taken in the global slots of its layout
    (``tp.seq.latent``; only the slot's owner writes it where they lie
    split)."""
    m = cfg.mla
    B = x.shape[0]
    f32 = torch.float32
    q_lat_x, ckv_new, krope_new = _mla_latents(params, cfg, x, angles,
                                               backend)
    q_nope, q_rope = _mla_queries(params, cfg, q_lat_x, angles)
    H = q_nope.shape[2]
    wuk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), wuk.to(f32))
    seq = None if tp is None else tp.seq
    cache_len = cache.ckv.shape[1] if seq is None else seq.latent.count
    at = (pos % cache_len).long()
    rows = torch.arange(B, device=x.device)
    if tp is not None:
        ckv_new, krope_new = tp.store_latent(ckv_new, krope_new)
    if seq is not None and seq.latent.split:
        seq.owner_write(cache.ckv, at, ckv_new[:, 0], seq.latent)
        seq.owner_write(cache.krope, at, krope_new[:, 0], seq.latent)
    else:
        cache.ckv[rows, at] = ckv_new[:, 0]
        cache.krope[rows, at] = krope_new[:, 0]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if tp is None:
        o_lat = latent_attention(q_lat, q_rope[:, 0].to(f32), cache, pos,
                                 scale)
    else:
        o_lat = tp.latent_attention(q_lat, q_rope[:, 0].to(f32), cache, pos,
                                    scale)
    wuv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", o_lat, wuv.to(f32))
    if head_mask is not None:
        out = out * head_mask[None, :, None]
    out = out.reshape(B, 1, H * m.v_head_dim).to(x.dtype) @ params["wo"]
    return (out if tp is None else tp.reduce(out)), cache
