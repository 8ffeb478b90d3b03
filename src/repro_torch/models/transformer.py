"""Decoder stack of the transformer families the port serves:

  dense   — pre-norm GQA + (gated / non-gated) FFN      [gemma, qwen, nemotron]
  ssm     — Mamba2 (SSD) blocks, attention-free         [mamba2]
  hybrid  — Mamba2 backbone + one SHARED attention block
            applied every ``shared_attn_period`` layers  [zamba2]

The reference (``models/transformer.py``) groups layers into homogeneous
*runs* and scans each run with ``lax.scan`` over stacked per-layer
weights; the port keeps the same stacked parameter layout (so trees cross
between the packages unchanged) and walks each run with a Python loop over
views of its stacked tensors. A hybrid run walks groups of ``period`` ssm
layers, each followed by the shared block, then the ungrouped tail. MoE,
MLA, audio, VLM and MTP configs raise ``NotImplementedError`` naming the
slice that brings them.

Three entry points, cache-consistent with each other:
  forward      — full sequence, logits for every position
  prefill      — full sequence, last-position logits + decode-ready cache
  decode_step  — one token per sequence against the cache

Pruning integration: ``masks`` mirrors the runs structure with per-layer
structured masks — attention ``head_mask`` (num_heads,), FFN ``ffn_mask``
(d_ff,) and SSD ``ssm_head_mask`` (ssm_heads,), stacked per run as
``(count, n_units)``. The shared block of a hybrid is not pruned.

``backend="auto"`` runs every kernel of the path (``rmsnorm``,
``flash_attention``, ``masked_matmul``, ``ssd_scan``) through its wrapper,
which launches the CUDA kernel for a tensor on the card and the plain
version for one on the CPU; ``backend="ref"`` runs the plain versions
wherever the tensors are (the yardstick on the card).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.attention import (KVCache, gqa_decode,
                                                 gqa_forward, init_gqa_params)
from repro_torch.models.layers import ssm as ssm_lib
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


def hybrid_split(cfg: ModelConfig, count: int) -> Tuple[int, int]:
    """(n_groups, tail) for a hybrid run of ``count`` ssm layers."""
    period = cfg.shared_attn_period
    return count // period, count % period


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose blocks the port
    does not have yet, naming the slice that brings them."""
    if cfg.arch_type == "moe" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks come with the MoE/MLA slice")
    if cfg.attention != "gqa" and cfg.arch_type != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention!r} attention comes with the "
            f"MoE/MLA slice")
    if cfg.arch_type == "audio" or cfg.embeds_input:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder comes with the audio slice")
    if cfg.arch_type == "vlm" or cfg.vision_tokens or cfg.rope_mode == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: vision tokens and M-RoPE come with the VLM slice")
    if cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: multi-token-prediction blocks are not ported")
    if cfg.arch_type not in ("dense", "ssm", "hybrid"):
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


def _init_ssm_layer(cfg: ModelConfig, gen: torch.Generator,
                    dtype: torch.dtype, device: torch.device):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ssm": ssm_lib.init_ssm_params(gen, cfg, dtype, device),
    }


_RUN_INIT = {"attn": _init_attn_layer, "ssm": _init_ssm_layer}


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
    scales, zero QKV biases; the Mamba2 block's own in
    ``ssm.init_ssm_params``), drawn from a ``torch.Generator`` seeded with
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
                                  _RUN_INIT[run.kind](cfg, gen, dtype, dev),
                                  i, run.count)
        params["runs"].append(stacked)
    if cfg.shared_attn_period:
        params["shared"] = _init_attn_layer(
            cfg.replace(d_ff=cfg.d_ff or 4 * cfg.d_model), gen, dtype, dev)
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


def _ssm_block(cfg, lp, x, mask, backend, collect_state: bool):
    head_mask = None if mask is None else mask.get("ssm_head_mask")
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    if collect_state:
        o, st = ssm_lib.ssm_forward(lp["ssm"], cfg, h, head_mask=head_mask,
                                    return_state=True, backend=backend)
        return x + o, st
    return x + ssm_lib.ssm_forward(lp["ssm"], cfg, h, head_mask=head_mask,
                                   backend=backend), None


def _shared_after(cfg: ModelConfig, count: int, j: int) -> Optional[int]:
    """The shared block's invocation that follows layer ``j`` of an ssm run
    of ``count`` layers (the last layer of each whole group of
    ``shared_attn_period``), else None."""
    period = cfg.shared_attn_period
    if not period or j >= hybrid_split(cfg, count)[0] * period \
            or (j + 1) % period:
        return None
    return j // period


def _run_stack(params, cfg: ModelConfig, x, angles, masks: Masks,
               backend: str, on_kv=None, on_state=None, on_shared_kv=None):
    """Run every layer over x. Each callback, when given, receives what
    prefill keeps: ``on_kv(run, layer_in_run, k, v)`` each attention
    layer's keys and values, ``on_state(run, layer_in_run, SSMCache)`` each
    Mamba2 layer's conv tail and final state, ``on_shared_kv(g, k, v)`` the
    keys and values of the shared block's invocation ``g``."""
    runs = layer_runs(cfg)
    masks = masks if masks is not None else [None] * len(runs)
    for r, (run, rp, rmask) in enumerate(zip(runs, params["runs"], masks)):
        for j in range(run.count):
            lp, mk = _index(rp, j), _index(rmask, j)
            if run.kind != "ssm":
                x, (k, v) = _attn_block(cfg, lp, x, angles, mk, backend)
                if on_kv is not None:
                    on_kv(r, j, k, v)
                continue
            x, st = _ssm_block(cfg, lp, x, mk, backend,
                               collect_state=on_state is not None)
            if on_state is not None:
                on_state(r, j, st)
            g = _shared_after(cfg, run.count, j)
            if g is not None:      # the shared block: unpruned
                x, (k, v) = _attn_block(cfg, params["shared"], x, angles,
                                        None, backend)
                if on_shared_kv is not None:
                    on_shared_kv(g, k, v)
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


def _zero_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                 device: torch.device) -> Dict[str, Any]:
    """{"runs": [KVCache((count, B, clen, Hkv, D) x2) for an attention run,
    SSMCache(conv (count, B, d_conv-1, conv_dim), state (count, B, H, P, N)
    float32) for an ssm run]} and, for a hybrid, "shared": KVCache((ninv,
    B, max_len, Hkv, D) x2), one slot per invocation of the shared block.
    A hybrid's ssm layers are stacked flat, in layer order (the reference
    splits them into (groups, period) and a tail)."""
    dtype = getattr(torch, cfg.dtype)
    clen = cache_len_for(cfg, max_len)

    def kv(n, length):
        return KVCache(*(torch.zeros(
            (n, batch_size, length, cfg.num_kv_heads, cfg.head_dim),
            dtype=dtype, device=device) for _ in range(2)))

    caches: List[Any] = []
    for run in layer_runs(cfg):
        if run.kind == "ssm":
            base = ssm_lib.init_ssm_cache(cfg, batch_size, dtype, device)
            caches.append(ssm_lib.SSMCache(*(
                t.new_zeros((run.count,) + tuple(t.shape)) for t in base)))
        else:
            caches.append(kv(run.count, clen))
    out: Dict[str, Any] = {"runs": caches}
    if cfg.shared_attn_period:
        out["shared"] = kv(max(cfg.num_layers // cfg.shared_attn_period, 1),
                           max_len)
    return out


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None):
    """Zero caches (``_zero_caches``) and ``"pos": (B,) int32`` on
    ``device`` (the card unless asked)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return dict(_zero_caches(cfg, batch_size, max_len, dev),
                pos=torch.zeros((batch_size,), dtype=torch.int32, device=dev))


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
    bidirectional config (no decode). Each layer's keys and values, or its
    conv tail and SSD state, are written into the cache as the layer
    finishes."""
    check_supported(cfg)
    _check_backend(backend)
    x, B, S = embed_inputs(params, cfg, batch)
    angles = _angles_for(cfg, B, S, 0, x.device)
    max_len = max_len or S
    callbacks = {}
    if cfg.causal:
        has_kv = cfg.shared_attn_period or any(
            run.kind != "ssm" for run in layer_runs(cfg))
        if has_kv and max_len < S and cfg.sliding_window is None:
            raise ValueError(
                f"prefill max_len={max_len} < prefill length {S}")
        caches = _zero_caches(cfg, B, max_len, x.device)

        def on_kv(r, j, k, v):
            kc, vc = _kv_to_cache(cfg, k, v, max_len)
            caches["runs"][r].k[j] = kc
            caches["runs"][r].v[j] = vc

        def on_state(r, j, st):
            caches["runs"][r].conv[j] = st.conv
            caches["runs"][r].state[j] = st.state

        def on_shared_kv(g, k, v):
            caches["shared"].k[g, :, :S] = k
            caches["shared"].v[g, :, :S] = v
        callbacks = dict(on_kv=on_kv, on_state=on_state,
                         on_shared_kv=on_shared_kv)
    x = _run_stack(params, cfg, x, angles, masks, backend, **callbacks)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, backend=backend)
    if not cfg.causal:
        return _lm_logits(params, cfg, x), None
    logits = _lm_logits(params, cfg, x[:, -1])
    caches["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                masks: Masks = None, backend: str = "auto"):
    """tokens (B,1) -> (logits (B,V), new cache). The tensors of ``cache``
    are updated in place (KV slots by ``gqa_decode``, each Mamba2 layer's
    conv window and state copied over); the returned cache holds them and
    the advanced positions."""
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
            if run.kind == "ssm":
                hm = None if mk is None else mk.get("ssm_head_mask")
                h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
                o, nc = ssm_lib.ssm_decode(
                    lp["ssm"], cfg, h,
                    ssm_lib.SSMCache(rc.conv[j], rc.state[j]), head_mask=hm)
                rc.conv[j].copy_(nc.conv)
                rc.state[j].copy_(nc.state)
                x = x + o
                g = _shared_after(cfg, run.count, j)
                if g is not None:      # the shared block's slot g
                    shared = cache["shared"]
                    x = _attn_decode(cfg, params["shared"], x, angles,
                                     KVCache(shared.k[g], shared.v[g]), pos,
                                     None, backend)
                continue
            x = _attn_decode(cfg, lp, x, angles, KVCache(rc.k[j], rc.v[j]),
                             pos, mk, backend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, backend=backend)
    logits = _lm_logits(params, cfg, x[:, 0])
    return logits, dict(cache, pos=pos + 1)


def _attn_decode(cfg, lp, x, angles, kv: KVCache, pos, mask, backend):
    """One token through an attention block; its key and value go into
    slot ``pos`` of ``kv``, in place."""
    hm = None if mask is None else mask.get("head_mask")
    fm = None if mask is None else mask.get("ffn_mask")
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    a, _ = gqa_decode(lp["attn"], cfg, h, angles, kv, pos, head_mask=hm)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps, backend=backend)
    return x + mlp_forward(lp["mlp"], h, cfg.activation, ffn_mask=fm,
                           backend=backend)
