"""Decoder / encoder stack of every transformer family of the registry:

  dense   — pre-norm GQA + (gated / non-gated) FFN      [gemma, qwen, nemotron]
  moe     — GQA or MLA attention + sort-dispatch MoE FFN,
            optionally after dense (``attn_dense``) layers [mixtral,
                                                            deepseek-v3]
  ssm     — Mamba2 (SSD) blocks, attention-free         [mamba2]
  hybrid  — Mamba2 backbone + one SHARED attention block
            applied every ``shared_attn_period`` layers  [zamba2]
  audio   — bidirectional encoder over precomputed frame
            embeddings (stubbed conv frontend)          [hubert]
  vlm     — dense decoder with M-RoPE; vision patch
            embeddings (stubbed ViT) prefix the text    [qwen2-vl]

The reference (``models/transformer.py``) groups layers into homogeneous
*runs* and scans each run with ``lax.scan`` over stacked per-layer
weights; the port keeps the same stacked parameter layout (so trees cross
between the packages unchanged) and walks each run with a Python loop over
views of its stacked tensors. A hybrid run walks groups of ``period`` ssm
layers, each followed by the shared block, then the ungrouped tail. An
MoE run sums its layers' router losses (``moe_aux``, ``moe_z``) as the
reference's scan carries them. An MLA stack (DeepSeek-V3) caches each
layer's KV latent and shared rotary key (``MLACache``) at ``max_len``, and
its rotary angles span ``qk_rope_head_dim``. A config with ``mtp_depth``
gets the reference's ``mtp`` subtree (its GQA block, projection and norm);
serving never runs it, ``loss_fn`` adds its next-next-token loss. An audio
config reads ``batch["embeds"]`` (B, S, d_model) in place of tokens; a VLM
config puts ``batch["vision_embeds"]`` (B, V, d_model) before the text
tokens' embeddings, and its M-RoPE angles come from
``batch["mrope_positions"]`` (3, B, S), or text positions where the batch
has none. The prefix counts toward ``max_len`` and the decode position.

Three entry points, cache-consistent with each other:
  forward      — full sequence, logits for every position
  prefill      — full sequence, last-position logits + decode-ready cache
  decode_step  — one token per sequence against the cache
and the training loss, ``loss_fn`` (the reference's line for line): the
mean token cross-entropy (``softmax_xent``; a VLM's labels padded with -1
over its vision prefix), the MoE router losses, and DeepSeek-V3's MTP loss
at weight 0.1. With ``cfg.remat`` and grad enabled, each layer body (and
each invocation of a hybrid's shared block) runs under a non-reentrant
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
scan bodies: its activations are recomputed in the backward, with the
same bits. Serving, with no grad, is untouched.

Pruning integration: ``masks`` mirrors the runs structure with per-layer
structured masks — attention ``head_mask`` (num_heads,), FFN ``ffn_mask``
(d_ff,), MoE ``expert_mask`` (num_experts,) and SSD ``ssm_head_mask``
(ssm_heads,), stacked per run as ``(count, n_units)``. The shared block of
a hybrid is not pruned.

``backend="auto"`` runs every kernel of the path (``rmsnorm`` and its gated
entry, ``flash_attention``, ``masked_matmul``, ``ssd_scan``) through its
wrapper, which launches the CUDA kernel for a tensor on the card and the
plain version for one on the CPU; ``backend="ref"`` runs the plain
versions wherever the tensors are (the yardstick on the card). Under
autograd every wrapper is an autograd Function with a backward in PyTorch
ops. The MoE
dispatch and expert products, and MLA's attention (naive or chunked), are
plain PyTorch on both backends, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, same_memory
from repro_torch.models.layers.attention import (KVCache, MLACache,
                                                 gqa_decode, gqa_forward,
                                                 init_gqa_params,
                                                 init_mla_params, mla_decode,
                                                 mla_forward)
from repro_torch.models.layers import ssm as ssm_lib
from repro_torch.models.layers.init import normal, slot
from repro_torch.models.layers.mlp import init_mlp_params, mlp_forward
from repro_torch.models.layers.moe import init_moe_params, moe_forward
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rope import (mrope_angles, positions_for,
                                            rope_angles,
                                            text_mrope_positions)
from repro_torch.sharding.tensor_parallel import vocab_xent

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
    """Raise ``NotImplementedError`` for an architecture type the stack
    does not know."""
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "audio",
                             "vlm"):
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
def _init_attention(cfg: ModelConfig, gen, dtype, device, out):
    init = init_mla_params if cfg.attention == "mla" else init_gqa_params
    return init(gen, cfg, dtype, device, out=out)


def _init_attn_layer(cfg: ModelConfig, gen: Optional[torch.Generator],
                     dtype: torch.dtype, device: torch.device, out=None):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": _init_attention(cfg, gen, dtype, device, slot(out, "attn")),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                               dtype, device, out=slot(out, "mlp")),
    }


def _init_moe_layer(cfg: ModelConfig, gen: Optional[torch.Generator],
                    dtype: torch.dtype, device: torch.device, out=None):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": _init_attention(cfg, gen, dtype, device, slot(out, "attn")),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "moe": init_moe_params(gen, cfg.d_model, cfg.moe, cfg.activation,
                               dtype, device, out=slot(out, "moe")),
    }


def _init_ssm_layer(cfg: ModelConfig, gen: Optional[torch.Generator],
                    dtype: torch.dtype, device: torch.device, out=None):
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ssm": ssm_lib.init_ssm_params(gen, cfg, dtype, device,
                                       out=slot(out, "ssm")),
    }


_RUN_INIT = {"attn": _init_attn_layer, "attn_dense": _init_attn_layer,
             "moe": _init_moe_layer, "ssm": _init_ssm_layer}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fill(dst, src) -> None:
    """Copy each leaf of ``src`` into ``dst``'s, unless it was drawn there
    already."""
    if isinstance(src, dict):
        for k, v in src.items():
            _fill(dst[k], v)
    elif not same_memory(src, dst):
        dst.copy_(src)


def _init_run(run: Run, cfg: ModelConfig, gen: torch.Generator,
              dtype: torch.dtype, device: torch.device):
    """A run's stacked tree: its (count, ...) tensors allocated from one
    pass of the layer's init on the ``meta`` device, then each layer drawn
    into its slots (``layers.init``), in layer order."""
    init = _RUN_INIT[run.kind]
    stacked = _map(lambda t: torch.empty((run.count,) + tuple(t.shape),
                                         dtype=t.dtype, device=device),
                   init(cfg, None, dtype, torch.device("meta")))
    for i in range(run.count):
        slots = _index(stacked, i)
        _fill(slots, init(cfg, gen, dtype, device, out=slots))
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the reference's tree layout and distributions
    (normal embeddings x 0.02, weights scaled by 1/sqrt(fan_in), unit norm
    scales, zero QKV biases; the Mamba2 block's own in
    ``ssm.init_ssm_params``), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless the caller asks for the CPU).
    Each tensor is drawn in float32, scaled in place and cast into its
    slot of the stacked run tensor, so the peak is the tree plus the
    largest float32 tensor. A config with ``mtp_depth`` also gets the
    reference's ``mtp`` subtree: the projection of [hidden; next
    embedding], a GQA attention block (an MLA config's block is GQA, as in
    the reference) and its norm."""
    check_supported(cfg)
    dev = resolve_device(device)
    # on the meta device (shapes and dtypes only, as the sharding specs
    # of a full-size config want them) nothing is drawn
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dtype = getattr(torch, cfg.dtype)
    V = cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": normal(gen, (V, cfg.d_model), dtype, dev, mul=0.02),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, V), dtype, dev,
                                   mul=1.0 / math.sqrt(cfg.d_model))
    params["runs"] = [_init_run(run, cfg, gen, dtype, dev)
                      for run in layer_runs(cfg)]
    if cfg.shared_attn_period:
        params["shared"] = _init_attn_layer(
            cfg.replace(d_ff=cfg.d_ff or 4 * cfg.d_model), gen, dtype, dev)
    if cfg.mtp_depth:
        d = cfg.d_model
        params["mtp"] = {
            "proj": normal(gen, (2 * d, d), dtype, dev,
                           div=math.sqrt(2 * d)),
            "block": _init_attn_layer(cfg.replace(attention="gqa"), gen,
                                      dtype, dev),
            "ln": torch.ones((d,), dtype=dtype, device=dev),
        }
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
def _embed(params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The tokens' rows of the embedding table (with ``tp``, the
    vocabulary-parallel lookup)."""
    return params["embed"][tokens] if tp is None else tp.embed(tokens)


def _top(params, name: str, tp=None) -> torch.Tensor:
    """A leaf outside the runs (``final_norm``), through ``tp`` where
    given."""
    return params[name] if tp is None else tp.top(name)


def embed_inputs(params, cfg: ModelConfig, batch,
                 tp=None) -> Tuple[torch.Tensor, int, int]:
    """(x (B, S, d_model), B, S): an audio config's frame embeddings in
    ``cfg.dtype``; a VLM config's vision embeddings, cast to the embedding
    table's dtype first, then its text tokens' embeddings (S counts
    both); else the tokens' embeddings. Where ``tp.seq`` splits the
    positions over the data axes, x and S are this rank's block of the
    whole sequence: the tokens cut before their embedding where they are
    the only input, a VLM's vision prefix joined before the cut."""
    seq = None if tp is None else tp.seq_tokens
    if cfg.embeds_input:                   # audio: stubbed conv frontend
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
        if seq is not None:
            x = seq.cut(x, 1)
    elif cfg.vision_tokens:                # vlm: vision prefix + text
        emb = _embed(params, batch["tokens"], tp)
        vis = batch["vision_embeds"].to(emb.dtype)        # (B, V, d)
        x = torch.cat([vis, emb], dim=1)
        if seq is not None:
            x = seq.cut(x, 1)
    else:
        tokens = batch["tokens"]
        x = _embed(params, tokens if seq is None else seq.cut(tokens, 1),
                   tp)
    B, S = x.shape[:2]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x, B, S


def _rope_dim(cfg: ModelConfig) -> int:
    """The width the rotary angles span: MLA's rotary head part, else the
    head dim."""
    return (cfg.mla.qk_rope_head_dim if cfg.attention == "mla"
            else cfg.head_dim)


def _angles_for(cfg: ModelConfig, batch, B: int, S: int, offset, device):
    """Rotary angles (B, S, rope_dim // 2) of positions ``offset`` ..
    ``offset + S - 1``; M-RoPE's from ``batch["mrope_positions"]`` where
    the batch has them (their positions ``offset`` .. ``offset + S - 1``:
    a sequence block's)."""
    if cfg.rope_mode == "none":
        return None
    if cfg.rope_mode == "mrope":
        pos = batch.get("mrope_positions")
        if pos is None:
            pos = text_mrope_positions(B, S, offset, device)
        else:
            pos = pos[..., offset:offset + S]
        return mrope_angles(pos, _rope_dim(cfg), cfg.rope_theta,
                            cfg.mrope_sections)
    pos = positions_for(B, S, offset, device).expand(B, S)
    return rope_angles(pos, _rope_dim(cfg), cfg.rope_theta)


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor,
               tp=None) -> torch.Tensor:
    """The head's logits; with ``tp``, this rank's vocabulary columns
    where the vocabulary is split."""
    if tp is not None:
        logits = tp.logits(x)
    else:
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        logits = x @ head
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


# ---------------------------------------------------------------------------
# stack walker (shared by forward & prefill)
# ---------------------------------------------------------------------------
def _attn_block(cfg, lp, x, angles, mask, backend, tp=None):
    """An attention block (GQA or MLA) with an FFN or an MoE layer (the
    reference's ``_attn_block`` and ``_moe_block``): (x, what the cache
    keeps — (k, v), or MLA's (ckv, k_rope) —, MoEMetrics or None). With
    ``tp`` the block is a tensor-parallel rank's share (its heads, FFN
    columns or experts) and ``lp`` is (run, layer), or the key path of an
    unstacked block (the MTP block): the layer's parameters are fetched
    here (``tp.layer``: its FSDP dims gathered, so that under remat the
    gather runs again in the backward) and its masks sliced to the rank's
    heads and FFN columns."""
    if tp is not None:
        lp, mask = tp.layer(*lp), tp.mask(mask)
    mask = mask or {}
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    split = {} if tp is None else {"tp": tp}
    attend = mla_forward if cfg.attention == "mla" else gqa_forward
    a, kv = attend(lp["attn"], cfg, h, angles,
                   head_mask=mask.get("head_mask"), backend=backend, **split)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps, backend=backend)
    if "moe" in lp:
        m, metrics = moe_forward(lp["moe"], cfg.moe, h, cfg.activation,
                                 expert_mask=mask.get("expert_mask"), **split)
        return x + m, kv, metrics
    return x + mlp_forward(lp["mlp"], h, cfg.activation,
                           ffn_mask=mask.get("ffn_mask"),
                           backend=backend, tp=tp), kv, None


def _ssm_block(cfg, lp, x, mask, backend, collect_state: bool, tp=None):
    """A Mamba2 block: (x, its conv tail and final state where
    ``collect_state``, else None). With ``tp`` the block is a rank's share
    of its SSD heads and ``lp`` is (run, layer): the layer's parameters
    are fetched here, inside its remat checkpoint (``_attn_block``), and
    its head mask sliced to the rank's heads."""
    if tp is not None:
        lp, mask = tp.layer(*lp), tp.mask(mask)
    head_mask = None if mask is None else mask.get("ssm_head_mask")
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    if collect_state:
        o, st = ssm_lib.ssm_forward(lp["ssm"], cfg, h, head_mask=head_mask,
                                    return_state=True, backend=backend,
                                    tp=tp)
        return x + o, st
    return x + ssm_lib.ssm_forward(lp["ssm"], cfg, h, head_mask=head_mask,
                                   backend=backend, tp=tp), None


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
               backend: str, on_kv=None, on_state=None, on_shared_kv=None,
               tp=None):
    """Run every layer over x; returns (x, {"moe_aux", "moe_z"}), the MoE
    layers' router losses summed (zeros without MoE layers). Each callback,
    when given, receives what prefill keeps: ``on_kv(run, layer_in_run,
    kv)`` each attention or MoE layer's (keys, values), or MLA's (latent,
    rotary key); ``on_state(run, layer_in_run, SSMCache)`` each Mamba2
    layer's conv tail and final state; ``on_shared_kv(g, k, v)`` the keys
    and values of the shared block's invocation ``g``. With ``cfg.remat``
    and grad enabled each block runs under a non-reentrant checkpoint
    (the callbacks see its outputs, outside it). With ``tp`` each layer
    and the shared block is a tensor-parallel rank's share
    (``_attn_block``, ``_ssm_block``)."""
    runs = layer_runs(cfg)
    masks = masks if masks is not None else [None] * len(runs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    zl = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def block(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)
    for r, (run, rp, rmask) in enumerate(zip(runs, params["runs"], masks)):
        for j in range(run.count):
            lp = (r, j) if tp is not None else _index(rp, j)
            mk = _index(rmask, j)
            if run.kind != "ssm":
                x, kv, metrics = block(_attn_block, cfg, lp, x, angles, mk,
                                       backend, tp)
                if metrics is not None:
                    aux = aux + metrics.aux_loss
                    zl = zl + metrics.z_loss
                if on_kv is not None:
                    on_kv(r, j, kv)
                continue
            x, st = block(_ssm_block, cfg, lp, x, mk, backend,
                          on_state is not None, tp)
            if on_state is not None:
                on_state(r, j, st)
            g = _shared_after(cfg, run.count, j)
            if g is not None:      # the shared block: unpruned
                shared = params["shared"] if tp is None else ("shared",)
                x, (k, v), _ = block(_attn_block, cfg, shared, x, angles,
                                     None, backend, tp)
                if on_shared_kv is not None:
                    on_shared_kv(g, k, v)
    return x, {"moe_aux": aux, "moe_z": zl}


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, batch, masks: Masks = None,
            backend: str = "auto", tp=None):
    """tokens (B,S) -> (logits (B,S,V), {"moe_aux", "moe_z", "hidden"}).
    With ``tp`` (a ``sharding.tensor_parallel.TensorParallel``) every
    parameter comes through it and the logits are the rank's vocabulary
    columns where the vocabulary is split (and its block of the positions
    where ``tp.seq`` splits them)."""
    check_supported(cfg)
    _check_backend(backend)
    x, B, S = embed_inputs(params, cfg, batch, tp)
    angles = _angles_for(cfg, batch, B, S, _offset(tp, S), x.device)
    x, aux = _run_stack(params, cfg, x, angles, masks, backend, tp=tp)
    x = rmsnorm(x, _top(params, "final_norm", tp), cfg.norm_eps,
                backend=backend)
    return _lm_logits(params, cfg, x, tp), dict(aux, hidden=x)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
#: weight of DeepSeek-V3's MTP loss in the total (the reference's)
MTP_WEIGHT = 0.1


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 parts: bool = False):
    """Mean token cross-entropy in fp32; labels < 0 are masked out, the
    sum divided by max(unmasked count, 1) (with ``parts``, the sum and the
    count)."""
    logits = logits.to(torch.float32)
    mask = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    nll = (torch.logsumexp(logits, dim=-1) - gold) * mask
    if parts:
        return nll.sum(), mask.sum()
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _mtp_loss(params, cfg: ModelConfig, batch, hidden: torch.Tensor,
              backend: str, tp=None) -> torch.Tensor:
    """DeepSeek-V3's next-next-token loss (the reference's, line for
    line): [h_t; emb(token_{t+1})] projected by ``mtp.proj``, the GQA
    block of the MTP config (MLA becomes GQA, M-RoPE standard rope, its
    angles from that config's own head dim), ``mtp.ln``, the LM head, and
    labels two ahead, -1 past the end. With ``tp``: the vocabulary-
    parallel embedding, head and cross-entropy, the block on the MTP
    config's split (``tp.for_config``), and where the data axes split the
    rows or the sequence the whole batch's mean (``_whole_xent``).

    Where ``tp.seq`` splits the positions, ``hidden`` is this rank's
    block and every rank holds the whole batch's tokens and labels: the
    MTP sequence of S - 1 positions is padded to S (a last position whose
    next token is 0 and whose label is -1; under the causal mask no
    earlier query reads it), so that it splits as the stack's does, and
    each rank takes its block of the next tokens and of the labels two
    ahead; the block attends at its offset (K and V gathered)."""
    seq = None if tp is None else tp.seq_tokens
    if seq is not None and (cfg.vision_tokens or not cfg.causal):
        raise ValueError(f"{cfg.name}: the MTP loss on a sequence split "
                         f"takes a causal text stack")
    h = hidden
    tokens = batch["tokens"]
    if seq is not None:             # the block's next tokens, 0 past the end
        tokens = seq.cut(F.pad(tokens[:, 1:], (0, 1)), 1)
    emb_next = _embed(params, tokens.clamp_min(0), tp)
    if cfg.scale_embeddings:
        emb_next = emb_next * torch.tensor(math.sqrt(cfg.d_model),
                                           dtype=emb_next.dtype)
    if cfg.vision_tokens:
        h = h[:, cfg.vision_tokens:]
    mtp = (params["mtp"] if tp is None else
           {"proj": tp.top("mtp", "proj"), "ln": tp.top("mtp", "ln")})
    if seq is None:                 # position t: h_t and token t + 1's
        h, emb_next = h[:, :-1], emb_next[:, 1:]
    hcat = torch.cat([h, emb_next], dim=-1) @ mtp["proj"]
    B2, S2 = hcat.shape[:2]
    mtp_cfg = cfg.replace(attention="gqa") if cfg.attention == "mla" else cfg
    if mtp_cfg.rope_mode == "mrope":
        mtp_cfg = mtp_cfg.replace(rope_mode="standard")
    ang = _angles_for(mtp_cfg, {}, B2, S2, _offset(tp, S2), hcat.device)
    if tp is None:
        hcat = _attn_block(mtp_cfg, params["mtp"]["block"], hcat, ang,
                           None, backend)[0]
    else:
        hcat = _attn_block(mtp_cfg, ("mtp", "block"), hcat, ang, None,
                           backend, tp.for_config(mtp_cfg))[0]
    hcat = rmsnorm(hcat, mtp["ln"], cfg.norm_eps, backend=backend)
    if seq is None:
        labels = F.pad(batch["labels"][:, 2:], (0, 1), value=-1)[:, :S2]
    else:
        labels = seq.cut(F.pad(batch["labels"][:, 2:], (0, 2), value=-1), 1)
    return _whole_xent(_lm_logits(params, cfg, hcat, tp), labels, tp)


def _whole_xent(logits: torch.Tensor, labels: torch.Tensor,
                tp=None) -> torch.Tensor:
    """``softmax_xent`` (with ``tp``, the vocabulary-parallel one where the
    vocabulary is split); where ``tp``'s data axes split the rows or the
    sequence, the whole batch's: the sum of every rank's terms over the
    count of every rank's labels (``tp.batch_sum``)."""
    if tp is not None and tp.vocab is not None:
        total, count = vocab_xent(logits, labels, tp.vocab[0], tp.axis,
                                  parts=True)
    else:
        total, count = softmax_xent(logits, labels, parts=True)
    if tp is not None:
        total, count = tp.batch_sum(total), tp.batch_count(count)
    return total / torch.clamp(count, min=1)


def loss_fn(params, cfg: ModelConfig, batch, masks: Masks = None,
            backend: str = "auto", tp=None):
    """-> (total, metrics): ``batch`` holds the model inputs and
    ``labels`` (B, S), S the text length (a VLM's labels are padded with
    -1 over its vision prefix). ``total = xent + moe_aux + moe_z``, plus
    ``MTP_WEIGHT`` x the MTP loss for a config with ``mtp_depth`` and an
    ``mtp`` subtree; ``metrics`` holds ``xent``, ``moe_aux``, ``moe_z``,
    ``mtp`` (where present) and ``loss``, as the reference's. With ``tp``
    the cross-entropy is the vocabulary-parallel one where the vocabulary
    is split; the router losses and the MTP loss are the whole batch's
    where the data axes split the rows (``moe_forward``, ``_mtp_loss``),
    the cross-entropy this rank's rows' own (a step weights it by the
    rank's share of the labels). Where ``tp.seq`` splits the positions,
    every rank holds the whole batch and the cross-entropy is its block's:
    the labels cut as the inputs are, after a VLM's pad over its vision
    prefix; the router and MTP losses are the whole sequence's."""
    logits, aux = forward(params, cfg, batch, masks, backend, tp)
    labels = batch["labels"]
    if cfg.vision_tokens:
        labels = F.pad(labels, (cfg.vision_tokens, 0), value=-1)
    if tp is not None and tp.seq_tokens is not None:
        labels = tp.seq_tokens.cut(labels, 1)
    if tp is None or tp.vocab is None:
        loss = softmax_xent(logits, labels)
    else:
        loss = vocab_xent(logits, labels, tp.vocab[0], tp.axis)
    total = loss + aux["moe_aux"] + aux["moe_z"]
    metrics = {"xent": loss, "moe_aux": aux["moe_aux"],
               "moe_z": aux["moe_z"]}
    if cfg.mtp_depth and "mtp" in params:
        mtp = _mtp_loss(params, cfg, batch, aux["hidden"], backend, tp)
        total = total + MTP_WEIGHT * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def _offset(tp, S: int) -> int:
    """The first position of a step's ``S`` (its sequence block's where
    ``tp.seq`` splits them)."""
    seq = None if tp is None else tp.seq_tokens
    return 0 if seq is None else seq.block(S)[0]


def _zero_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                 device: torch.device, tp=None) -> Dict[str, Any]:
    """{"runs": [KVCache((count, B, clen, Hkv, D) x2) for an attention run,
    MLACache(ckv (count, B, max_len, kv_lora_rank), krope (count, B,
    max_len, rope_dim)) for an MLA stack's, SSMCache(conv (count, B,
    d_conv-1, conv_dim), state (count, B, H, P, N) float32) for an ssm
    run]} and, for a hybrid, "shared": KVCache((ninv, B, max_len, Hkv, D)
    x2), one slot per invocation of the shared block. A hybrid's ssm
    layers are stacked flat, in layer order (the reference splits them
    into (groups, period) and a tail). With ``tp`` a KV cache holds the
    rank's shard of the heads and head dims, an MLA cache its shard of
    each leaf's last dim, an SSM cache its shard of the conv channels and
    of the state's heads; where ``tp.seq`` splits the slots over the data
    axes, a KV or MLA leaf holds the rank's block of them."""
    dtype = getattr(torch, cfg.dtype)
    clen = cache_len_for(cfg, max_len)
    heads, dims = cfg.num_kv_heads, cfg.head_dim
    if tp is not None and tp.heads is not None:
        heads = tp.kv_heads[1] - tp.kv_heads[0]
        dims = tp.kv_dims[1] - tp.kv_dims[0]
    seq = None if tp is None else tp.seq

    def local(n, leaf):
        """A leaf's slots here: ``n``, or this rank's of the split's
        layout ``leaf`` (``"kv"`` or ``"latent"``)."""
        if seq is None:
            return n
        lay = getattr(seq, leaf)
        return lay.hi - lay.lo

    def kv(n, length):
        return KVCache(*(torch.zeros(
            (n, batch_size, length, heads, dims),
            dtype=dtype, device=device) for _ in range(2)))

    caches: List[Any] = []
    for run in layer_runs(cfg):
        if run.kind == "ssm":
            base = ssm_lib.init_ssm_cache(cfg, batch_size, dtype, device)
            if tp is not None:
                (c0, c1), (h0, h1) = tp.conv_dims, tp.state_heads
                base = ssm_lib.SSMCache(base.conv[..., c0:c1],
                                        base.state[:, h0:h1])
            caches.append(ssm_lib.SSMCache(*(
                t.new_zeros((run.count,) + tuple(t.shape)) for t in base)))
        elif cfg.attention == "mla":
            widths = ((cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)
                      if tp is None else
                      tuple(hi - lo for lo, hi in tp.latent_dims))
            slots = local(max_len, "latent")
            caches.append(MLACache(*(torch.zeros(
                (run.count, batch_size, slots, width), dtype=dtype,
                device=device) for width in widths)))
        else:
            caches.append(kv(run.count, local(clen, "kv")))
    out: Dict[str, Any] = {"runs": caches}
    if cfg.shared_attn_period:
        out["shared"] = kv(max(cfg.num_layers // cfg.shared_attn_period, 1),
                           local(max_len, "kv"))
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
            f"prefill max_len={max_len} < prefill length {S} "
            "(vision or audio prefix tokens count toward max_len)")
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
            masks: Masks = None, backend: str = "auto", tp=None):
    """Returns (last_logits (B,V), cache) — or (all_logits, None) for a
    bidirectional config (no decode). Each layer's keys and values, or its
    conv tail and SSD state, are written into the cache as the layer
    finishes. With ``tp`` the cache holds the rank's shard
    (``TensorParallel.store_kv``) and the logits are gathered whole. Where
    ``tp.seq`` splits the positions over the data axes, each rank runs its
    block of them; each cache leaf holds the rank's slots
    (``SeqSplit.cache_slots``, taken from the whole sequence's keys every
    rank gathered), the last logits are the last rank's on every rank
    (``SeqSplit.last``), and a bidirectional config's logits are the
    rank's block."""
    check_supported(cfg)
    _check_backend(backend)
    seq = None if tp is None else tp.seq_tokens
    x, B, S = embed_inputs(params, cfg, batch, tp)
    angles = _angles_for(cfg, batch, B, S, _offset(tp, S), x.device)
    S_all = S if seq is None else S * seq.n
    max_len = max_len or S_all
    callbacks = {}
    if cfg.causal:
        if seq is not None and seq.max_len != max_len:
            raise ValueError(f"prefill max_len={max_len} is not the "
                             f"sequence split's {seq.max_len}")
        has_kv = cfg.shared_attn_period or any(
            run.kind != "ssm" for run in layer_runs(cfg))
        if has_kv and max_len < S_all and cfg.sliding_window is None:
            raise ValueError(
                f"prefill max_len={max_len} < prefill length {S_all} "
                "(vision or audio prefix tokens count toward max_len)")
        caches = _zero_caches(cfg, B, max_len, x.device, tp)

        def on_kv(r, j, kv):
            dst = caches["runs"][r]
            if cfg.attention == "mla":        # (ckv, k_rope) at max_len
                if seq is not None:
                    kv = [seq.cache_slots(t, seq.latent, 1) for t in kv]
                if tp is not None:
                    kv = tp.store_latent(*kv)
                n = kv[0].shape[1]
                dst.ckv[j, :, :n] = kv[0]
                dst.krope[j, :, :n] = kv[1]
                return
            if seq is not None:
                kv = [seq.cache_slots(t, seq.kv, 1) for t in kv]
            if tp is not None:
                kv = tp.store_kv(*kv)
            if seq is not None:
                dst.k[j], dst.v[j] = kv
                return
            kc, vc = _kv_to_cache(cfg, *kv, max_len)
            dst.k[j] = kc
            dst.v[j] = vc

        def on_state(r, j, st):
            caches["runs"][r].conv[j] = st.conv
            caches["runs"][r].state[j] = st.state

        def on_shared_kv(g, k, v):
            if seq is not None:
                k, v = (seq.cache_slots(t, seq.kv, 1) for t in (k, v))
            if tp is not None:
                k, v = tp.store_kv(k, v)
            n = k.shape[1]
            caches["shared"].k[g, :, :n] = k
            caches["shared"].v[g, :, :n] = v
        callbacks = dict(on_kv=on_kv, on_state=on_state,
                         on_shared_kv=on_shared_kv)
    x, _ = _run_stack(params, cfg, x, angles, masks, backend, tp=tp,
                      **callbacks)
    x = rmsnorm(x, _top(params, "final_norm", tp), cfg.norm_eps,
                backend=backend)
    whole = (lambda t: t) if tp is None else tp.gather_vocab
    if not cfg.causal:
        return whole(_lm_logits(params, cfg, x, tp)), None
    last = x[:, -1] if seq is None else seq.last(x[:, -1])
    logits = whole(_lm_logits(params, cfg, last, tp))
    caches["pos"] = torch.full((B,), S_all, dtype=torch.int32,
                               device=x.device)
    return logits, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                masks: Masks = None, backend: str = "auto", tp=None):
    """tokens (B,1) -> (logits (B,V), new cache). The tensors of ``cache``
    are updated in place (KV slots by ``gqa_decode``, latent slots by
    ``mla_decode``, each Mamba2 layer's conv window and state copied over);
    the returned cache holds them and the advanced positions. With ``tp``
    the cache holds the rank's shard (``prefill`` with ``tp``) and the
    logits are gathered whole; where ``tp.seq`` splits the slots over the
    data axes (its layout: ``SeqSplit.kv`` and ``SeqSplit.latent``), a KV
    or MLA leaf holds the rank's block, and each attention combines the
    ranks' partial softmaxes."""
    check_supported(cfg)
    _check_backend(backend)
    pos = cache["pos"]
    x = _embed(params, tokens[:, 0], tp)[:, None]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.rope_mode == "mrope":     # t == h == w == pos, prefix counted
        p3 = pos[None, :, None].expand(3, pos.shape[0], 1)
        angles = mrope_angles(p3, _rope_dim(cfg), cfg.rope_theta,
                              cfg.mrope_sections)
    elif cfg.rope_mode == "none":
        angles = None
    else:
        angles = rope_angles(pos[:, None], _rope_dim(cfg), cfg.rope_theta)
    runs = layer_runs(cfg)
    masks = masks if masks is not None else [None] * len(runs)
    for r, (run, rp, rc, rmask) in enumerate(zip(runs, params["runs"],
                                                 cache["runs"], masks)):
        for j in range(run.count):
            lp = tp.layer(r, j) if tp is not None else _index(rp, j)
            mk = _index(rmask, j)
            if tp is not None:
                mk = tp.mask(mk)
            if run.kind == "ssm":
                hm = None if mk is None else mk.get("ssm_head_mask")
                h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
                o, nc = ssm_lib.ssm_decode(
                    lp["ssm"], cfg, h,
                    ssm_lib.SSMCache(rc.conv[j], rc.state[j]), head_mask=hm,
                    backend=backend, tp=tp)
                rc.conv[j].copy_(nc.conv)
                rc.state[j].copy_(nc.state)
                x = x + o
                g = _shared_after(cfg, run.count, j)
                if g is not None:      # the shared block's slot g
                    shared = cache["shared"]
                    sp = (params["shared"] if tp is None
                          else tp.layer("shared"))
                    x = _attn_decode(cfg, sp, x, angles,
                                     KVCache(shared.k[g], shared.v[g]), pos,
                                     None, backend, tp)
                continue
            x = _attn_decode(cfg, lp, x, angles,
                             type(rc)(*(t[j] for t in rc)), pos, mk, backend,
                             tp)
    x = rmsnorm(x, _top(params, "final_norm", tp), cfg.norm_eps,
                backend=backend)
    logits = _lm_logits(params, cfg, x[:, 0], tp)
    if tp is not None:
        logits = tp.gather_vocab(logits)
    return logits, dict(cache, pos=pos + 1)


def _attn_decode(cfg, lp, x, angles, kv, pos, mask, backend, tp=None):
    """One token through an attention or MoE block; its key and value (a
    ``KVCache``), or its latent and rotary key (an ``MLACache``), go into
    slot ``pos`` of ``kv``, in place (in the global slots of ``tp.seq``'s
    layout where it splits the sequence). An MoE block dispatches the
    step's B tokens as one ``moe_forward`` (capacity ``capacity(B)``, at
    least 8 slots an expert)."""
    mask = mask or {}
    split = {} if tp is None else {"tp": tp}
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps, backend=backend)
    if cfg.attention == "mla":
        a, _ = mla_decode(lp["attn"], cfg, h, angles, kv, pos,
                          head_mask=mask.get("head_mask"), backend=backend,
                          **split)
    else:
        a, _ = gqa_decode(lp["attn"], cfg, h, angles, kv, pos,
                          head_mask=mask.get("head_mask"), tp=tp)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps, backend=backend)
    if "moe" in lp:
        m, _ = moe_forward(lp["moe"], cfg.moe, h, cfg.activation,
                           expert_mask=mask.get("expert_mask"), **split)
        return x + m
    return x + mlp_forward(lp["mlp"], h, cfg.activation,
                           ffn_mask=mask.get("ffn_mask"), backend=backend,
                           tp=tp)
