"""A dense decoder for the LM drivers: the seeded weights and masks, and
the port's serving steps built on them.

The configuration file holds the published ``config.json`` keys; the
port's own config is its registry entry (``program``) with every one of
those keys put in, so what runs is what the file says.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

import torch

from perfbench.lib import counts, seeded

#: published key -> the port's ``ModelConfig`` field
PROGRAM_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
                "num_attention_heads": "num_heads",
                "num_key_value_heads": "num_kv_heads",
                "head_dim": "head_dim", "intermediate_size": "d_ff",
                "vocab_size": "vocab_size", "rope_theta": "rope_theta",
                "rms_norm_eps": "norm_eps", "qkv_bias": "qkv_bias",
                "torch_dtype": "dtype",
                "tie_word_embeddings": "tie_embeddings"}


def program_config(cfg: dict):
    """The port's ``ModelConfig`` for the configuration file ``cfg``."""
    base = importlib.import_module(cfg["program"]).CONFIG
    kw = {field: cfg[key] for key, field in PROGRAM_KEYS.items()
          if key in cfg}
    kw.setdefault("head_dim", cfg["hidden_size"]
                  // cfg["num_attention_heads"])
    if cfg.get("hidden_act") != "silu" or cfg.get("tie_word_embeddings"):
        raise ValueError("the dense decoder here is SiLU-gated, untied")
    return base.replace(**kw)


@dataclass
class Model:
    m: dict                     # sizes (``seeded.lm_dims``)
    k: dict                     # kept units a layer (``counts.lm_kept``)
    w: Dict[str, torch.Tensor]  # flat seeded weights
    masks: Dict[str, torch.Tensor]
    pcfg: object                # the port's config
    params: dict                # the port's tree (views of ``w``)
    pmasks: list                # the port's per-run masks

    def prefill_step(self, max_len: int, device):
        from repro_torch.launch.steps import make_prefill_step
        return make_prefill_step(self.pcfg, max_len=max_len,
                                 masks=self.pmasks, device=device)

    def decode_step(self, device):
        from repro_torch.launch.steps import make_decode_step
        return make_decode_step(self.pcfg, masks=self.pmasks, device=device)


def build(cfg: dict, seed: int, device) -> Model:
    m = seeded.lm_dims(cfg)
    ratio = cfg["assumed"]["mask_ratio"]
    w = seeded.lm_weights(m, seed, device)
    masks = seeded.lm_masks(m, ratio, seed, device)
    return Model(m=m, k=counts.lm_kept(m, ratio), w=w, masks=masks,
                 pcfg=program_config(cfg), params=seeded.lm_program_tree(w),
                 pmasks=[dict(masks)])
