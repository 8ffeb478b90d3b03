"""Decoder stack of the dense transformer families (gemma, qwen, nemotron):
pre-norm GQA attention + (gated / non-gated) FFN, layer after layer.

The reference (``models/transformer.py``) groups layers into homogeneous
*runs* and scans each run with ``lax.scan`` over stacked per-layer
weights; the port keeps the same stacked parameter layout (so trees cross
between the packages unchanged) and walks each run with a Python loop over
views of its stacked tensors. Only ``attn`` runs are ported so far: MoE,
SSM, hybrid, MLA, audio and VLM configs raise ``NotImplementedError``
naming the slice that brings them.

Three entry points, cache-consistent with each other:
  forward      — full sequence, logits for every position
  prefill      — full sequence, last-position logits + decode-ready cache
  decode_step  — one token per sequence against the cache

Pruning integration: ``masks`` mirrors the runs structure with per-layer
structured masks — attention ``head_mask`` (num_heads,) and FFN
``ffn_mask`` (d_ff,), stacked per run as ``(count, n_units)``.

``backend="auto"`` runs every kernel of the path (``rmsnorm``,
``flash_attention``, ``masked_matmul``) through its wrapper, which
launches the CUDA kernel for a tensor on the card and the plain version
for one on the CPU; ``backend="ref"`` runs the plain versions wherever the
tensors are (the yardstick on the card).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.attention import (KVCache, gqa_decode,
                                                 gqa_forward, init_gqa_params)
from repro_torch.models.layers.mlp import init_mlp_params, mlp_forward
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rope import positions_for, rope_angles

BACKENDS = ("auto", "ref")
Masks = Optional[List[Optional[Dict[str, torch.Tensor]]]]


# ---------------------------------------------------------------------------
# run grouping and what this slice serves
# ---------------------------------------------------------------------------
class Run(NamedTuple):
    kind: str      # attn | attn_dense | moe | ssm
    start: int
    count: int


def layer_runs(cfg: ModelConfig) -> List[Run]:
    kinds = cfg.layer_kinds()
    runs: List[Run] = []
    for i, k in enumerate(kinds):
        if runs and runs[-1].kind == k:
            runs[-1] = Run(k, runs[-1].start, runs[-1].count + 1)
        else:
            runs.append(Run(k, i, 1))
    return runs


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose blocks the port
    does not have yet, naming the slice that brings them."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2/SSD blocks (ssd_scan) come with the "
            f"Mamba2 slice (port slice 3)")
    if cfg.arch_type == "moe" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks come with the MoE/MLA slice")
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention!r} attention comes with the "
            f"MoE/MLA slice")
    if cfg.arch_type == "audio" or cfg.embeds_input:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder comes with the audio slice")
    if cfg.arch_type == "vlm" or cfg.vision_tokens or cfg.rope_mode == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: vision tokens and M-RoPE come with the VLM slice")
    if cfg.shared_attn_period or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: shared-attention and MTP blocks are not ported")
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"{cfg.name}: arch {cfg.arch_type!r}")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (use {BACKENDS})")


def _index(tree, i: int):
    """Layer ``i`` of a stacked (nested dict of) tensors: views, no copy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_attn_layer(cfg: ModelConfig, gen: torch.Generator,
                     dtype: torch.dtype, device: torch.device):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_gqa_params(gen, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                               dtype, device),
    }


def _stack_into(dst, src, i: int, count: int):
    """Write layer ``i``'s tree into the stacked tree ``dst`` (allocated
    from the first layer's shapes); returns ``dst``."""
    if isinstance(src, dict):
        dst = {} if dst is None else dst
        for k, v in src.items():
            dst[k] = _stack_into(dst.get(k), v, i, count)
        return dst
    if dst is None:
        dst = torch.empty((count,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
    dst[i] = src
    return dst


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the reference's tree layout and distributions
    (normal embeddings x 0.02, weights scaled by 1/sqrt(fan_in), unit norm
    scales, zero QKV biases), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless the caller asks for the CPU).
    Each tensor is drawn in float32 and cast on its own, one layer at a
    time, so no float32 copy of the model is ever held."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    V = cfg.padded_vocab

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(dtype)

    params: Dict[str, Any] = {
        "embed": normal((V, cfg.d_model), 0.02),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, V),
                                   1.0 / math.sqrt(cfg.d_model))
    params["runs"] = []
    for run in layer_runs(cfg):
        stacked = None
        for i in range(run.count):
            stacked = _stack_into(stacked,
                                  _init_attn_layer(cfg, gen, dtype, dev),
                                  i, run.count)
        params["runs"].append(stacked)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def cast_params(params, dtype: torch.dtype):
    """A copy of the parameter tree in ``dtype`` (e.g. a float32 twin of a
    bf16 model, the yardstick of its numerics)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype)


# ---------------------------------------------------------------------------
# embedding, rope, head
# ---------------------------------------------------------------------------
def embed_inputs(params, cfg: ModelConfig,
                 batch) -> Tuple[torch.Tensor, int, int]:
    tok = batch["tokens"]
    B, S = tok.shape
    x = params["embed"][tok]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x, B, S


def _angles_for(cfg: ModelConfig, B: int, S: int, offset, device):
    if cfg.rope_mode == "none":
        return None
    pos = positions_for(B, S, offset, device).expand(B, S)
    return rope_angles(pos, cfg.head_dim, cfg.rope_theta)


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = x @ head
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


# ---------------------------------------------------------------------------
# stack walker (shared by forward & prefill)
# ---------------------------------------------------------------------------
def _attn_block(cfg, lp, x, angles, mask, backend):
    head_mask = None if mask is None else mask.get("head_mask")
    ffn_mask = None if mask is None else mask.get("ffn_mask")
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    a, kv = gqa_forward(lp["attn"], cfg, h, angles, head_mask=head_mask,
                        backend=backend)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps, backend=backend)
    x = x + mlp_forward(lp["mlp"], h, cfg.activation, ffn_mask=ffn_mask,
                        backend=backend)
    return x, kv


def _run_stack(params, cfg: ModelConfig, x, angles, masks: Masks,
               backend: str, on_kv=None):
    """Run every layer over x; ``on_kv(run_index, layer_in_run, k, v)``
    receives each layer's keys and values (prefill fills its cache)."""
    runs = layer_runs(cfg)
    masks = masks if masks is not None else [None] * len(runs)
    for r, (run, rp, rmask) in enumerate(zip(runs, params["runs"], masks)):
        for j in range(run.count):
            x, (k, v) = _attn_block(cfg, _index(rp, j), x, angles,
                                    _index(rmask, j), backend)
            if on_kv is not None:
                on_kv(r, j, k, v)
    return x


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, batch, masks: Masks = None,
            backend: str = "auto"):
    """tokens (B,S) -> (logits (B,S,V), {"moe_aux", "moe_z", "hidden"})."""
    check_supported(cfg)
    _check_backend(backend)
    x, B, S = embed_inputs(params, cfg, batch)
    angles = _angles_for(cfg, B, S, 0, x.device)
    x = _run_stack(params, cfg, x, angles, masks, backend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, backend=backend)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_logits(params, cfg, x), {"moe_aux": zero, "moe_z": zero,
                                        "hidden": x}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def _zero_caches(cfg: ModelConfig, batch_size: int, clen: int,
                 device: torch.device) -> List[KVCache]:
    dtype = getattr(torch, cfg.dtype)
    return [KVCache(*(torch.zeros(
        (run.count, batch_size, clen, cfg.num_kv_heads, cfg.head_dim),
        dtype=dtype, device=device) for _ in range(2)))
        for run in layer_runs(cfg)]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None):
    """Zero KV caches ``{"runs": [KVCache((count, B, clen, Hkv, D) x2)],
    "pos": (B,) int32}`` on ``device`` (the card unless asked)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"runs": _zero_caches(cfg, batch_size,
                                 cache_len_for(cfg, max_len), dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def _kv_to_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                 max_len: int):
    """k/v (..., S, Hkv, D) -> rolling/padded cache of cache_len_for()."""
    S = k.shape[-3]
    clen = cache_len_for(cfg, max_len)
    if clen == S:
        return k, v
    if clen < S and cfg.sliding_window is None:
        raise ValueError(
            f"prefill max_len={max_len} < prefill length {S}")
    if clen < S:     # sliding window rolling buffer: slot = pos % clen
        k = torch.roll(k[..., S - clen:, :, :], S % clen, dims=-3)
        v = torch.roll(v[..., S - clen:, :, :], S % clen, dims=-3)
        return k, v
    pad = [0, 0, 0, 0, 0, clen - S]          # last three dims: D, Hkv, S
    return (torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad))


# ---------------------------------------------------------------------------
# prefill: full sequence -> (last logits, decode-ready cache)
# ---------------------------------------------------------------------------
def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None,
            masks: Masks = None, backend: str = "auto"):
    """Returns (last_logits (B,V), cache) — or (all_logits, None) for a
    bidirectional config (no decode). Each layer's keys and values are
    written into the cache as the layer finishes."""
    check_supported(cfg)
    _check_backend(backend)
    x, B, S = embed_inputs(params, cfg, batch)
    angles = _angles_for(cfg, B, S, 0, x.device)
    max_len = max_len or S
    if cfg.causal:
        clen = cache_len_for(cfg, max_len)
        if clen < S and cfg.sliding_window is None:
            raise ValueError(
                f"prefill max_len={max_len} < prefill length {S}")
        caches = _zero_caches(cfg, B, clen, x.device)

        def on_kv(r, j, k, v):
            kc, vc = _kv_to_cache(cfg, k, v, max_len)
            caches[r].k[j] = kc
            caches[r].v[j] = vc
    else:
        on_kv = None
    x = _run_stack(params, cfg, x, angles, masks, backend, on_kv)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, backend=backend)
    if not cfg.causal:
        return _lm_logits(params, cfg, x), None
    logits = _lm_logits(params, cfg, x[:, -1])
    cache = {"runs": caches,
             "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                masks: Masks = None, backend: str = "auto"):
    """tokens (B,1) -> (logits (B,V), new cache). The KV tensors of
    ``cache`` are updated in place (``gqa_decode``); the returned cache
    holds them and the advanced positions."""
    check_supported(cfg)
    _check_backend(backend)
    pos = cache["pos"]
    x = params["embed"][tokens[:, 0]][:, None]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    angles = (None if cfg.rope_mode == "none" else
              rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta))
    runs = layer_runs(cfg)
    masks = masks if masks is not None else [None] * len(runs)
    for run, rp, rc, rmask in zip(runs, params["runs"], cache["runs"],
                                  masks):
        for j in range(run.count):
            lp, mk = _index(rp, j), _index(rmask, j)
            hm = None if mk is None else mk.get("head_mask")
            fm = None if mk is None else mk.get("ffn_mask")
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
            a, _ = gqa_decode(lp["attn"], cfg, h, angles,
                              KVCache(rc.k[j], rc.v[j]), pos, head_mask=hm)
            x = x + a
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps, backend=backend)
            x = x + mlp_forward(lp["mlp"], h, cfg.activation, ffn_mask=fm,
                                backend=backend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, backend=backend)
    logits = _lm_logits(params, cfg, x[:, 0])
    return logits, dict(cache, pos=pos + 1)
