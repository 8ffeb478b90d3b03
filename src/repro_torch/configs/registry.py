"""Architecture registry: ``--arch <id>`` resolution for every launcher.

Each module in this package exports CONFIG (exact published shape, citation
in brackets) and smoke_config() (reduced same-family variant). It holds
every config of the JAX package's registry, in its order: dense, Mamba2
SSM, the Zamba2 hybrid, MoE (Mixtral's GQA stack and DeepSeek-V3's MLA
stack with dense first layers), the HuBERT audio encoder and the Qwen2-VL
vision-language decoder with M-RoPE.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "mamba2-2.7b",
    "gemma-7b",
    "qwen1.5-4b",
    "qwen2-7b",
    "hubert-xlarge",
    "nemotron-4-340b",
    "qwen2-vl-7b",
    "zamba2-1.2b",
    "deepseek-v3-671b",
    "mixtral-8x7b",
]

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen2-7b": "qwen2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "nemotron-4-340b": "nemotron4_340b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x7b": "mixtral_8x7b",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
