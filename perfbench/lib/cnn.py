"""An AlexNet-family CNN for the CNN drivers: the seeded weights and
masks, and the port's config for the configuration file (its registry
entry with the file's layer list, classes and input put in)."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, List

import torch

from perfbench.lib import seeded

_SPEC_KEYS = ("out_channels", "kernel", "stride", "padding", "features")


def program_config(cfg: dict):
    from repro_torch.configs.base import ConvLayerSpec
    base = importlib.import_module(cfg["program"]).CONFIG
    layers = tuple(ConvLayerSpec(s["kind"], **{k: s[k] for k in _SPEC_KEYS
                                               if k in s})
                   for s in cfg["layers"])
    return dataclasses.replace(base, layers=layers,
                               num_classes=cfg["num_classes"],
                               input_hw=tuple(cfg["input_hw"]),
                               input_channels=cfg["input_channels"],
                               dtype=cfg["dtype"])


@dataclass
class Model:
    layers: List[dict]                # ``seeded.cnn_layers``
    w: Dict[str, torch.Tensor]        # flat seeded weights
    masks: Dict[int, torch.Tensor]
    pcfg: object
    params: dict                      # the port's tree (views of ``w``)

    def kept(self) -> Dict[int, int]:
        return {i: int(m.sum()) for i, m in self.masks.items()}


def build(cfg: dict, seed: int, device) -> Model:
    layers = seeded.cnn_layers(cfg)
    w = seeded.cnn_weights(layers, seed, device)
    masks = seeded.cnn_masks(layers, cfg["assumed"]["mask_ratio"], seed,
                             device)
    return Model(layers=layers, w=w, masks=masks,
                 pcfg=program_config(cfg),
                 params=seeded.cnn_program_params(w))
