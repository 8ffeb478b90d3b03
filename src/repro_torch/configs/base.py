"""CNN config dataclasses, copied from the JAX package's ``configs/base.py``.

Field names, order and defaults are identical to the reference's: the plan
digest hashes ``dataclasses.asdict`` of these, so two peers agree on a
plan only if the fields do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    kind: str                     # conv | maxpool | flatten | dense | relu | lrn
    out_channels: int = 0
    kernel: int = 0
    stride: int = 1
    padding: int = 0
    features: int = 0             # dense width


@dataclass(frozen=True)
class CNNConfig:
    name: str
    layers: Tuple[ConvLayerSpec, ...]
    num_classes: int
    input_hw: Tuple[int, int] = (224, 224)
    input_channels: int = 3
    dtype: str = "float32"
    citation: str = ""
