"""Architecture registry: ``--arch <id>`` resolution for every launcher.

Each module in this package exports CONFIG (exact published shape, citation
in brackets) and smoke_config() (reduced same-family variant). It holds the
families the port serves (dense, Mamba2 SSM and the Zamba2 hybrid), plus
one MoE config whose blocks come with a later slice (the stack refuses
it); the other families of the JAX package come with the slice that runs
them.
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
    "nemotron-4-340b",
    "zamba2-1.2b",
    "mixtral-8x7b",
]

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen2-7b": "qwen2_7b",
    "nemotron-4-340b": "nemotron4_340b",
    "zamba2-1.2b": "zamba2_1p2b",
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
