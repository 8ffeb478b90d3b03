"""The AlexNet-family CNN of the JAX package's ``models/cnn.py``, in PyTorch.

Every op (conv / relu / pool / flatten / dense) is a *layer* in the paper's
sense: a candidate split point for the partitioner and (for conv/dense) a
prunable unit. Layouts follow the reference so that parameters, masks and
split-boundary tensors cross between the packages unchanged:

  * activations are NHWC at every public function and at every split
    boundary (that tensor goes on the wire); a conv or pool layer converts
    to NCHW only inside itself, for ``F.conv2d``/``F.max_pool2d``;
  * flatten is a plain reshape of the NHWC tensor, so a dense layer's input
    index is ``(h*W + w)*C + c``, as in the reference;
  * parameters are ``{"l{i}": {"w", "b"}}`` with conv weights HWIO
    ``(kh, kw, Cin, Cout)`` and dense weights ``(din, dout)``. ``run_layers``
    takes conv weights in PyTorch's OIHW layout instead (``oihw_params``),
    so a caller that runs many requests converts once.

Channel pruning is mask-based: ``masks[i]`` is a 0/1 vector over layer i's
output channels (conv) or units (dense), multiplied in after the bias add.
``compact_params`` physically removes the pruned channels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig, ConvLayerSpec

Params = Dict[str, Dict[str, torch.Tensor]]


def alexnet_config(num_classes: int = 38) -> CNNConfig:
    L = ConvLayerSpec
    return CNNConfig(
        name="alexnet",
        layers=(
            L("conv", out_channels=64, kernel=11, stride=4, padding=2),   # 0
            L("relu"),                                                    # 1
            L("maxpool", kernel=3, stride=2),                             # 2
            L("conv", out_channels=192, kernel=5, stride=1, padding=2),   # 3
            L("relu"),                                                    # 4
            L("maxpool", kernel=3, stride=2),                             # 5
            L("conv", out_channels=384, kernel=3, stride=1, padding=1),   # 6
            L("relu"),                                                    # 7
            L("conv", out_channels=256, kernel=3, stride=1, padding=1),   # 8
            L("relu"),                                                    # 9
            L("conv", out_channels=256, kernel=3, stride=1, padding=1),   # 10
            L("relu"),                                                    # 11
            L("maxpool", kernel=3, stride=2),                             # 12
            L("flatten"),                                                 # 13
            L("dense", features=4096),                                    # 14
            L("relu"),                                                    # 15
            L("dense", features=4096),                                    # 16
            L("relu"),                                                    # 17
            L("dense", features=num_classes),                             # 18
        ),
        num_classes=num_classes,
        input_hw=(224, 224),
        citation="AlexNet (Krizhevsky et al. 2012); layer list per "
                 "torchvision; paper Figs. 2-4 profile this network.",
    )


def tiny_cnn_config(num_classes: int = 38, width: float = 0.25,
                    hw: int = 64) -> CNNConfig:
    """Reduced AlexNet-family CNN for CPU tests."""
    L = ConvLayerSpec
    w = lambda c: max(8, int(c * width))          # noqa: E731
    return CNNConfig(
        name="tiny_alexnet",
        layers=(
            L("conv", out_channels=w(64), kernel=5, stride=2, padding=2),
            L("relu"),
            L("maxpool", kernel=3, stride=2),
            L("conv", out_channels=w(192), kernel=3, stride=1, padding=1),
            L("relu"),
            L("maxpool", kernel=3, stride=2),
            L("conv", out_channels=w(256), kernel=3, stride=1, padding=1),
            L("relu"),
            L("maxpool", kernel=3, stride=2),
            L("flatten"),
            L("dense", features=256),
            L("relu"),
            L("dense", features=num_classes),
        ),
        num_classes=num_classes,
        input_hw=(hw, hw),
        citation="reduced AlexNet-family CNN (this work, CPU smoke scale)",
    )


# ---------------------------------------------------------------------------
def _out_hw(hw: int, k: int, s: int, p: int) -> int:
    return (hw + 2 * p - k) // s + 1


def layer_shapes(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """Output shape (C, H, W) or (F,) per layer, batch-free."""
    h, w = cfg.input_hw
    c = cfg.input_channels
    shapes: List[Tuple[int, ...]] = []
    for spec in cfg.layers:
        if spec.kind == "conv":
            h = _out_hw(h, spec.kernel, spec.stride, spec.padding)
            w = _out_hw(w, spec.kernel, spec.stride, spec.padding)
            c = spec.out_channels
            shapes.append((c, h, w))
        elif spec.kind == "maxpool":
            h = _out_hw(h, spec.kernel, spec.stride, 0)
            w = _out_hw(w, spec.kernel, spec.stride, 0)
            shapes.append((c, h, w))
        elif spec.kind == "relu":
            shapes.append(shapes[-1] if shapes else (c, h, w))
        elif spec.kind == "flatten":
            shapes.append((c * h * w,))
        elif spec.kind == "dense":
            shapes.append((spec.features,))
        else:
            raise ValueError(spec.kind)
    return shapes


def param_shapes(cfg: CNNConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{"l{i}": {"w": shape, "b": shape}}`` for every conv/dense layer,
    in the reference layout (HWIO conv weights, ``(din, dout)`` dense)."""
    shapes = layer_shapes(cfg)
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    c_in = cfg.input_channels
    flat_in = None
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            out[f"l{i}"] = {"w": (spec.kernel, spec.kernel, c_in,
                                  spec.out_channels),
                            "b": (spec.out_channels,)}
            c_in = spec.out_channels
        elif spec.kind == "flatten":
            flat_in = shapes[i][0]
        elif spec.kind == "dense":
            d_in = flat_in if flat_in is not None else shapes[i - 1][0]
            out[f"l{i}"] = {"w": (d_in, spec.features),
                            "b": (spec.features,)}
            flat_in = spec.features
    return out


def init_cnn_params(seed: int, cfg: CNNConfig) -> Params:
    """He-normal weights and zero biases from a numpy seed (CPU tensors).
    The draws differ from the reference's ``jax.random`` stream; tests
    hand the same numpy arrays to both packages instead."""
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, cfg.dtype)
    params: Params = {}
    for name, shp in param_shapes(cfg).items():
        w = shp["w"]
        fan_in = int(np.prod(w[:-1]))
        arr = rng.standard_normal(w, dtype=np.float32) * np.float32(
            math.sqrt(2.0 / fan_in))
        params[name] = {"w": torch.from_numpy(arr).to(dtype),
                        "b": torch.zeros(shp["b"], dtype=dtype)}
    return params


def oihw_params(params: Params, cfg: CNNConfig) -> Params:
    """The same parameters with conv weights in PyTorch's OIHW layout
    (dense weights and biases unchanged), for ``run_layers``."""
    out = dict(params)
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            p = params[f"l{i}"]
            out[f"l{i}"] = {"w": p["w"].permute(3, 2, 0, 1).contiguous(),
                            "b": p["b"]}
    return out


def masks_to(masks, device: torch.device,
             dtype: torch.dtype = torch.float32
             ) -> Optional[Dict[int, torch.Tensor]]:
    """Mask dict (numpy arrays or tensors) as float tensors on ``device``."""
    if not masks:
        return None
    return {int(i): torch.as_tensor(np.asarray(m) if not torch.is_tensor(m)
                                    else m).to(device=device, dtype=dtype)
            for i, m in masks.items()}


def maxpool_nhwc(x: torch.Tensor, spec: ConvLayerSpec) -> torch.Tensor:
    """VALID max-pool over H and W of an NHWC tensor (the reference's
    ``reduce_window`` with ``-inf`` fill; floor division of the window
    count, so no padded element ever wins)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), spec.kernel, spec.stride)
    return y.permute(0, 2, 3, 1).contiguous()


def run_layers(tparams: Params, cfg: CNNConfig, x: torch.Tensor,
               masks: Optional[Dict[int, torch.Tensor]] = None,
               return_intermediates: bool = False,
               start_layer: int = 0, stop_layer: Optional[int] = None):
    """Run layers [start_layer, stop_layer) on the NHWC tensor ``x`` with
    ``tparams`` from ``oihw_params``. Split inference runs [0, c) on the
    edge and [c, N) on the cloud."""
    masks = masks or {}
    stop = stop_layer if stop_layer is not None else len(cfg.layers)
    inter = []
    for i in range(start_layer, stop):
        spec = cfg.layers[i]
        if spec.kind == "conv":
            p = tparams[f"l{i}"]
            y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], stride=spec.stride,
                         padding=spec.padding)
            x = y.permute(0, 2, 3, 1) + p["b"]
            if i in masks:
                x = x * masks[i].to(x.dtype)
            x = x.contiguous()
        elif spec.kind == "relu":
            x = torch.relu(x)
        elif spec.kind == "maxpool":
            x = maxpool_nhwc(x, spec)
        elif spec.kind == "flatten":
            x = x.reshape(x.shape[0], -1)
        elif spec.kind == "dense":
            p = tparams[f"l{i}"]
            x = x @ p["w"] + p["b"]
            if i in masks:
                x = x * masks[i].to(x.dtype)
        if return_intermediates:
            inter.append(x)
    if return_intermediates:
        return x, inter
    return x


def cnn_apply(params: Params, cfg: CNNConfig, x: torch.Tensor,
              masks: Optional[Dict[int, torch.Tensor]] = None,
              return_intermediates: bool = False,
              start_layer: int = 0, stop_layer: Optional[int] = None):
    """``run_layers`` on reference-layout (HWIO) parameters: the
    counterpart of the reference's ``cnn_apply``, same arguments."""
    return run_layers(oihw_params(params, cfg), cfg, x, masks=masks,
                      return_intermediates=return_intermediates,
                      start_layer=start_layer, stop_layer=stop_layer)


def prunable_layers(cfg: CNNConfig) -> List[int]:
    """Indices the pruning agent controls (conv + hidden dense, not the
    head)."""
    out = [i for i, s in enumerate(cfg.layers) if s.kind == "conv"]
    dense = [i for i, s in enumerate(cfg.layers) if s.kind == "dense"]
    out += dense[:-1]          # never prune the classifier head
    return out


def _keep(mask) -> np.ndarray:
    m = mask.detach().cpu().numpy() if torch.is_tensor(mask) else mask
    return np.nonzero(np.asarray(m) > 0)[0]


def compact_cnn_config(cfg: CNNConfig, masks) -> CNNConfig:
    """Shape-only compaction: shrink conv out_channels / dense features to
    the surviving counts, without touching params."""
    new_specs = list(cfg.layers)
    for i, spec in enumerate(cfg.layers):
        if i not in masks:
            continue
        kept = int(_keep(masks[i]).size)
        if spec.kind == "conv":
            new_specs[i] = ConvLayerSpec("conv", out_channels=kept,
                                         kernel=spec.kernel,
                                         stride=spec.stride,
                                         padding=spec.padding)
        elif spec.kind == "dense":
            new_specs[i] = ConvLayerSpec("dense", features=kept)
    return dataclasses.replace(cfg, layers=tuple(new_specs))


def split_keep_indices(cfg: CNNConfig, masks, split: int
                       ) -> Optional[np.ndarray]:
    """Surviving-unit indices along the LAST axis of the activation that
    crosses split point ``split`` under masked execution, or None when
    every unit is live (feeds the codec's channel packing). Relu/pool
    inherit the producing layer's mask, flatten expands it across spatial
    positions, and an unmasked conv/dense mixes all inputs."""
    if split <= 0 or not masks:
        return None
    shapes = layer_shapes(cfg)
    carry: Optional[np.ndarray] = None
    for i in range(split):
        spec = cfg.layers[i]
        if spec.kind in ("conv", "dense"):
            carry = _keep(masks[i]) if i in masks else None
        elif spec.kind == "flatten" and carry is not None:
            c, h, w = shapes[i - 1]
            carry = (np.arange(h * w)[:, None] * c
                     + carry[None, :]).reshape(-1)
    if carry is None:
        return None
    n_full = shapes[split - 1][0]
    return None if carry.size == n_full else carry


def compact_params(params: Params, cfg: CNNConfig, masks
                   ) -> Tuple[Params, CNNConfig]:
    """Physically remove pruned channels (deployment-time compaction).

    Returns (new_params, new_cfg) with conv out_channels / dense features
    shrunk to the surviving counts and downstream input dims following;
    a conv->flatten->dense transition expands the channel mask across the
    spatial positions of the NHWC-flattened activation."""
    shapes = layer_shapes(cfg)
    new_specs = list(cfg.layers)
    new_params = {k: dict(v) for k, v in params.items()}
    carry: Optional[torch.Tensor] = None    # input-dim keep indices
    for i, spec in enumerate(cfg.layers):
        if spec.kind in ("conv", "dense"):
            p = new_params[f"l{i}"]
            w = p["w"]
            dev = w.device
            if carry is not None:
                w = (w[:, :, carry.to(dev), :] if spec.kind == "conv"
                     else w[carry.to(dev), :])
            keep = (torch.from_numpy(_keep(masks[i])) if i in masks
                    else torch.arange(w.shape[-1]))
            new_params[f"l{i}"] = {"w": w[..., keep.to(dev)].contiguous(),
                                   "b": p["b"][keep.to(dev)].contiguous()}
            if spec.kind == "conv":
                new_specs[i] = ConvLayerSpec(
                    "conv", out_channels=int(keep.numel()),
                    kernel=spec.kernel, stride=spec.stride,
                    padding=spec.padding)
                carry = keep
            else:
                new_specs[i] = ConvLayerSpec("dense",
                                             features=int(keep.numel()))
                carry = keep if i in masks else None
        elif spec.kind == "flatten" and carry is not None:
            c, h, w_ = shapes[i - 1]
            # NHWC flatten: index = (h*W + w)*C + c
            carry = (torch.arange(h * w_)[:, None] * c
                     + carry[None, :]).reshape(-1)
    return new_params, dataclasses.replace(cfg, layers=tuple(new_specs))


def cnn_abs_bound(tparams: Params, cfg: CNNConfig, delta: torch.Tensor,
                  masks: Optional[Dict[int, torch.Tensor]] = None,
                  start_layer: int = 0) -> torch.Tensor:
    """Elementwise bound on how far the output of layers [start_layer, N)
    can move when its NHWC input moves by at most ``delta`` (same shape,
    >= 0) in each element. Conv and dense layers propagate through
    ``|w|`` with no bias; relu and max-pool are 1-Lipschitz per element,
    so the bound passes relu unchanged and is max-pooled. Used to bound
    the logit change one int8 codec step at the split can cause."""
    absp = {k: {"w": v["w"].abs(), "b": torch.zeros_like(v["b"])}
            for k, v in tparams.items()}
    masks = {i: m.abs() for i, m in (masks or {}).items()}
    return run_layers(absp, cfg, delta, masks=masks, start_layer=start_layer)
