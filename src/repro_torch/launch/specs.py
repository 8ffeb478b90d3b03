"""Shape stand-ins for every (architecture x input shape) pair, the port
of the JAX package's ``launch/specs.py``: ``meta``-device tensors (shape
and dtype, no allocation) in place of ``ShapeDtypeStruct``s.

Assigned shapes:
    train_4k     seq 4,096    global_batch 256   (training)
    prefill_32k  seq 32,768   global_batch 32    (inference-prefill)
    decode_32k   seq 32,768   global_batch 128   (inference-decode)
    long_500k    seq 524,288  global_batch 1     (long-context decode)

Decode shapes mean: ONE new token against a KV cache of seq_len.
``supported()`` is the reference's skip table (an encoder has no decode;
long_500k needs sub-quadratic or compressed-cache attention).

Tokens and labels are int64, as ``launch.steps.batch_on`` types them (the
reference's are int32); ``mrope_positions`` int32 and embeddings in the
model's dtype, as the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr

SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

LONG_OK = {"mamba2-2.7b", "zamba2-1.2b", "mixtral-8x7b", "deepseek-v3-671b"}

#: the type of token ids and labels (``steps.batch_on``)
TOKEN_DTYPE = torch.int64
META = torch.device("meta")


def mode_of(shape_name: str) -> str:
    if shape_name.startswith("train"):
        return "train"
    if shape_name.startswith("prefill"):
        return "prefill"
    return "decode"


def supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    mode = mode_of(shape_name)
    if mode == "decode" and not cfg.causal:
        return False, "encoder-only: no autoregressive decode (DESIGN.md)"
    if shape_name == "long_500k" and cfg.name not in LONG_OK:
        return False, ("full-attention dense arch: 500k decode skipped "
                       "(needs SSM/SWA/MLA-compressed cache; DESIGN.md)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape_name: str,
                    with_labels: bool) -> Dict[str, torch.Tensor]:
    S, B = SHAPES[shape_name]
    return batch_meta(cfg, B, S, with_labels)


def batch_meta(cfg: ModelConfig, B: int, S: int,
               with_labels: bool = False) -> Dict[str, torch.Tensor]:
    """A batch of B rows and S positions (a VLM's vision prefix counted)
    as ``meta`` tensors."""
    d = getattr(torch, cfg.dtype)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.embeds_input:
        batch["embeds"] = _meta((B, S, cfg.d_model), d)
    elif cfg.vision_tokens:
        V = cfg.vision_tokens
        batch["tokens"] = _meta((B, S - V), TOKEN_DTYPE)
        batch["vision_embeds"] = _meta((B, V, cfg.d_model), d)
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), TOKEN_DTYPE)
    if with_labels:
        batch["labels"] = _meta((B, S - cfg.vision_tokens), TOKEN_DTYPE)
    return batch


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Everything the traced step consumes, as ``meta`` tensors.

    train   -> {params, batch}
    prefill -> {params, batch}
    decode  -> {params, cache, tokens}
    """
    mode = mode_of(shape_name)
    S, B = SHAPES[shape_name]
    params = tr.init_params(cfg, device=META)
    if mode in ("train", "prefill"):
        return {"params": params,
                "batch": batch_specs_for(cfg, shape_name,
                                         with_labels=mode == "train")}
    return {"params": params, "cache": tr.init_cache(cfg, B, S, device=META),
            "tokens": _meta((B, 1), TOKEN_DTYPE)}
