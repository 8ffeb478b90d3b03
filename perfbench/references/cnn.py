"""Plain fp32 AlexNet-family CNN, its int8 edge and the wire codec, in
PyTorch ops.

Written from the deployment the configuration states: the network
compacted to its masks' kept channels (a pruned channel is gone, and so
is the next layer's input from it); the edge half's conv weights
quantized per output channel onto ``levels`` + 1 affine code points
(min/max range, ``zero`` = min, codes rounded half to even), then used as
``codes * scale + zero`` in fp32; the boundary feature of each wire frame
affinely quantized onto 256 code points with the frame's own min and max
and dequantized; the cloud half in fp32. Convolutions, pools and
products are PyTorch's (``conv2d``, ``max_pool2d``, ``@``), TF32 off. It
imports nothing of the program and takes nothing it made: weights and
masks are the benchmark's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.references.transformer import full_fp32


def compact(layers: List[dict], w: Dict[str, torch.Tensor],
            masks: Dict[int, torch.Tensor]) -> Dict[int, dict]:
    """Each conv / dense layer's weights and bias with the pruned output
    channels and the inputs from pruned channels taken out (HWIO convs,
    (in, out) dense; an NHWC flatten's rows follow the kept channels at
    every position)."""
    out, carry = {}, None
    for i, spec in enumerate(layers):
        kind = spec["kind"]
        if kind not in ("conv", "dense"):
            if kind == "flatten" and carry is not None:
                c, h, wd = spec["in"]
                carry = (torch.arange(h * wd, device=carry.device)[:, None]
                         * c + carry[None, :]).reshape(-1)
            continue
        wt, b = w[f"l{i}.w"], w[f"l{i}.b"]
        if carry is not None:
            wt = wt[:, :, carry] if kind == "conv" else wt[carry]
        keep = (masks[i].nonzero()[:, 0] if i in masks
                else torch.arange(wt.shape[-1], device=wt.device))
        out[i] = {"w": wt[..., keep].float(), "b": b[keep].float()}
        carry = keep if (kind == "conv" or i in masks) else None
    return out


def affine_codes(x: torch.Tensor, levels: int,
                 dim=None) -> torch.Tensor:
    """``x`` through min/max affine quantization onto ``levels`` + 1 code
    points and back (per slice of ``dim`` kept, else over the whole
    tensor): ``clip(round((x - min) / scale)) * scale + min`` with ``scale
    = (max - min) / levels`` taken in float64 and rounded to float32 (1
    where the range is empty)."""
    if dim is None:
        mn, mx = x.min(), x.max()
    else:
        red = [d for d in range(x.dim()) if d != dim % x.dim()]
        mn, mx = x.amin(dim=red, keepdim=True), x.amax(dim=red, keepdim=True)
    scale = ((mx.double() - mn.double()) / levels).float()
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round((x - mn) / scale).clamp_(0, levels)
    return q * scale + mn


def quantized_edge(cl: Dict[int, dict], layers: List[dict], split: int,
                   levels: int) -> Dict[int, dict]:
    """The edge half's conv / dense layers with their weights through
    ``affine_codes`` per output channel."""
    return {i: {"w": affine_codes(p["w"], levels, dim=-1), "b": p["b"]}
            if i < split else p for i, p in cl.items()}


def run(cl: Dict[int, dict], layers: List[dict], x: torch.Tensor,
        start: int, stop: int, masks=None) -> torch.Tensor:
    """Layers [start, stop) on NHWC ``x`` (fp32, TF32 off, no autograd);
    with ``masks`` each masked layer's output channels multiplied by its
    mask (the uncompacted network)."""
    with full_fp32(), torch.no_grad():
        return _layers(cl, layers, x, start, stop, masks or {}).contiguous()


def _layers(cl, layers, x, start, stop, masks):
    for i in range(start, stop):
        spec = layers[i]
        kind = spec["kind"]
        if kind == "conv":
            y = F.conv2d(x.permute(0, 3, 1, 2),
                         cl[i]["w"].permute(3, 2, 0, 1),
                         stride=spec["stride"], padding=spec["padding"])
            x = y.permute(0, 2, 3, 1) + cl[i]["b"]
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "maxpool":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), spec["kernel"],
                             spec["stride"]).permute(0, 2, 3, 1)
        elif kind == "flatten":
            x = x.reshape(x.shape[0], -1)
        elif kind == "dense":
            x = x @ cl[i]["w"] + cl[i]["b"]
        if i in masks:
            x = x * masks[i]
    return x


def flat(tree) -> Dict[str, torch.Tensor]:
    """``{"l{i}": {"w", "b"}}`` -> ``{"l{i}.w": ..., "l{i}.b": ...}``."""
    return {f"{k}.{n}": t for k, v in tree.items() for n, t in v.items()}


def loss_and_grads(layers: List[dict], p: Dict[str, torch.Tensor],
                   masks: Dict[int, torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor, tf32: bool = False):
    """Mean cross-entropy of the masked network on (x, y) and its
    gradient by autograd, fp32 with TF32 off (``tf32``: on, the control).
    ``p`` holds ``l{i}.w`` / ``l{i}.b`` leaves."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    cl = {int(k[1:].split(".")[0]): {} for k in leaves}
    for k, t in leaves.items():
        cl[int(k[1:].split(".")[0])][k.split(".")[1]] = t
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.enable_grad():
            logits = _layers(cl, layers, x, 0, len(layers), masks)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return loss.detach(), dict(zip(leaves, grads))


def frame_bytes(feature_shape: Tuple[int, ...], n: int) -> int:
    """Wire bytes of an int8 feature frame of ``n`` rows, compacted (no
    channel bitmap): magic, codec, packed flag and rank (8), the shape (8
    a dim), scale and zero (8), the payload length (8), one byte a
    value."""
    return 8 + 8 * (1 + len(feature_shape)) + 8 + 8 \
        + n * math.prod(feature_shape)
