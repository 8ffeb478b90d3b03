"""Quantized kernel edge path (the JAX package's ``core/collab/quant.py``).

The edge submodel's conv and dense layers run through the column-masked
GEMM ``kernels/masked_matmul``:

  * **conv layers** lower to im2col (``F.unfold`` on the NCHW view, whose
    patch features come out channel-major ``(c, kh, kw)`` like the
    reference's ``conv_general_dilated_patches``) followed by one masked
    GEMM against the HWIO weights re-laid-out as ``(Cin*kh*kw, Cout)``;
  * **dense layers** are the masked GEMM directly;
  * relu / maxpool / flatten are the ops of ``models.cnn.run_layers``.

Weights are optionally quantized to int8/int4 **per output channel** on
the host with the wire codec's affine math (``protocol.affine_quantize``),
byte for byte as the reference does, giving the per-layer contract

    |y_quant - y_fp32|_n <= (scale_n / 2) * ||x||_1      (``gemm_error_bound``)

The reference dequantizes ``codes * scale + zero`` as a tensor op ahead of
its Pallas kernel; so does the port on the CPU and with ``backend="ref"``.
On the card a quantized layer goes to ``masked_matmul_q8``, whose kernel
dequantizes each code as it loads it, with the same two roundings, so the
GEMM multiplies by the same float32 weights while reading a quarter of the
bytes.

Backend resolution (``resolve_backend``): ``"ref"`` — the plain PyTorch
GEMM; ``"pallas"`` — the hand-written kernel (the name is kept so plans
and digests cross between the packages unchanged; here it names the CUDA
kernel); ``"auto"`` — the kernel on a CUDA device, the plain GEMM on the
CPU. On a CPU tensor the kernel's wrapper runs its plain version anyway.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.protocol import affine_quantize
from repro_torch.core.partition.latency_model import KernelCalibration
from repro_torch.kernels.masked_matmul.ops import (masked_matmul,
                                                   masked_matmul_q8)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch.models.cnn import masks_to, maxpool_nhwc

#: affine code-point count per bit width (the codec uses 255 for int8)
BITS_LEVELS: Dict[int, int] = {8: 255, 4: 15}
BACKENDS: Tuple[str, ...] = ("auto", "pallas", "ref")
CALIBRATIONS: Tuple[str, ...] = ("minmax",)


@dataclass(frozen=True)
class QuantPolicy:
    """The ``quant`` section of a ``DeploymentPlan``: how the edge
    submodel's conv/dense layers execute. Same fields, validation and JSON
    as the reference's, so the section folds into the same digest.

    ``weight_bits`` — 8 or 4 for per-channel affine weight quantization,
    ``None`` for fp32 weights (kernel dispatch only). ``per_channel``
    quantizes each output channel with its own (scale, zero); ``False``
    uses one pair per tensor. ``backend`` picks the GEMM (module
    docstring); ``calibration`` names the range estimator (``"minmax"``).
    """
    weight_bits: Optional[int] = 8
    per_channel: bool = True
    backend: str = "auto"
    calibration: str = "minmax"

    def __post_init__(self) -> None:
        if self.weight_bits is not None and self.weight_bits not in BITS_LEVELS:
            raise ValueError(f"weight_bits must be one of "
                             f"{sorted(BITS_LEVELS)} or None, "
                             f"got {self.weight_bits!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(use {BACKENDS})")
        if self.calibration not in CALIBRATIONS:
            raise ValueError(f"unknown calibration {self.calibration!r} "
                             f"(use {CALIBRATIONS})")

    def to_json(self) -> Dict[str, Any]:
        """Serializable section dict (``weight_bits`` is the only
        dimensioned key; the rest are enums/flags)."""
        return {"weight_bits": self.weight_bits,
                "per_channel": self.per_channel,
                "backend": self.backend,
                "calibration": self.calibration}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "QuantPolicy":
        """Inverse of ``to_json`` (absent keys take the defaults)."""
        return cls(weight_bits=doc.get("weight_bits"),
                   per_channel=bool(doc.get("per_channel", True)),
                   backend=doc.get("backend", "auto"),
                   calibration=doc.get("calibration", "minmax"))

    def describe(self) -> str:
        """Short human summary, e.g. ``int8/pc@auto`` or ``fp32@ref``."""
        w = ("fp32" if self.weight_bits is None
             else f"int{self.weight_bits}"
                  + ("/pc" if self.per_channel else "/pt"))
        return f"{w}@{self.backend}"


def resolve_backend(policy: QuantPolicy, device: torch.device) -> str:
    """-> ``"pallas"`` (the CUDA kernel) or ``"ref"`` (plain GEMM) for a
    bank that runs on ``device``."""
    if policy.backend == "auto":
        return "pallas" if device.type == "cuda" else "ref"
    return policy.backend


# ---------------------------------------------------------------------------
# weight quantization (the codec's affine math, per output channel, on host)
# ---------------------------------------------------------------------------
def quantize_weights(w: np.ndarray, bits: int, per_channel: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a weight tensor onto ``BITS_LEVELS[bits]`` code points with
    ``protocol.affine_quantize`` — per slice of the LAST axis (the output
    channel) when ``per_channel``. Returns (uint8 codes in ``w``'s shape,
    scale, zero); scale/zero are float32 arrays of shape ``(N,)`` (or
    scalars for per-tensor)."""
    levels = BITS_LEVELS[bits]
    w = np.asarray(w, np.float32)
    if not per_channel:
        q, s, z = affine_quantize(w, levels)
        return q, np.float32(s), np.float32(z)
    flat = w.reshape(-1, w.shape[-1])
    codes = np.empty(flat.shape, np.uint8)
    scale = np.empty(flat.shape[-1], np.float32)
    zero = np.empty(flat.shape[-1], np.float32)
    for n in range(flat.shape[-1]):
        codes[:, n], scale[n], zero[n] = affine_quantize(flat[:, n], levels)
    return codes.reshape(w.shape), scale, zero


def conv_weight_gemm_layout(w: np.ndarray) -> np.ndarray:
    """HWIO conv weights ``(kh, kw, Cin, N)`` -> the im2col GEMM operand
    ``(Cin*kh*kw, N)``, rows channel-major ``(c, kh, kw)`` to match the
    patch features of ``F.unfold``."""
    kh, kw, cin, n = w.shape
    return np.transpose(np.asarray(w, np.float32),
                        (2, 0, 1, 3)).reshape(cin * kh * kw, n)


def quantize_params(params, cfg: CNNConfig, policy: QuantPolicy
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The deployed (post-compaction) params -> the GEMM-layout bank
    ``quant_cnn_apply`` consumes: per conv/dense layer either
    ``{"wq", "scale", "zero", "b"}`` or ``{"w", "b"}`` (fp32,
    ``weight_bits=None``), conv weights in im2col layout. Quantization
    runs on the host in numpy; the tensors land on the weights' device.
    Biases are never quantized."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, spec in enumerate(cfg.layers):
        if spec.kind not in ("conv", "dense"):
            continue
        p = params[f"l{i}"]
        dev = p["w"].device
        w = p["w"].detach().to(torch.float32).cpu().numpy()
        if spec.kind == "conv":
            w = conv_weight_gemm_layout(w)
        b = p["b"].detach().to(torch.float32)
        if policy.weight_bits is None:
            out[f"l{i}"] = {"w": torch.from_numpy(w).to(dev), "b": b}
        else:
            codes, scale, zero = quantize_weights(
                w, policy.weight_bits, policy.per_channel)
            out[f"l{i}"] = {"wq": torch.from_numpy(codes).to(dev),
                            "scale": torch.as_tensor(scale).to(dev),
                            "zero": torch.as_tensor(zero).to(dev), "b": b}
    return out


def dequantize_weights(lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """codes * scale + zero (broadcast over the output-channel axis), or
    the fp32 passthrough."""
    if "wq" in lp:
        return lp["wq"].to(torch.float32) * lp["scale"] + lp["zero"]
    return lp["w"]


def gemm_error_bound(x: torch.Tensor, scale) -> torch.Tensor:
    """Elementwise bound on ``|GEMM(x, dequant(w)) - GEMM(x, w)|``: output
    n errs by at most ``(scale_n / 2) * ||x_row||_1``. Broadcasts to
    ``(..., N)``; fp32 accumulation adds only relative-eps slack."""
    s = torch.atleast_1d(torch.as_tensor(scale, dtype=torch.float32,
                                         device=x.device))
    l1 = x.abs().sum(dim=-1, keepdim=True)
    return l1 * (s * 0.5)


# ---------------------------------------------------------------------------
# the kernel-dispatched forward
# ---------------------------------------------------------------------------
def _gemm(x: torch.Tensor, lp: Dict[str, torch.Tensor], mvec: torch.Tensor,
          backend: str) -> torch.Tensor:
    """x @ dequant(layer) * mvec: the plain GEMM after the dequant for
    ``"ref"``; else the kernel, from the codes where the layer has them."""
    if backend == "ref":
        return masked_matmul_ref(x, dequantize_weights(lp), mvec)
    if "wq" in lp:
        return masked_matmul_q8(x, lp["wq"], lp["scale"], lp["zero"], mvec)
    return masked_matmul(x, lp["w"], mvec)


def im2col_nhwc(x: torch.Tensor, kernel: int, stride: int,
                padding: int) -> torch.Tensor:
    """NHWC ``(B, H, W, C)`` -> contiguous patches ``(B, Ho, Wo,
    C*kh*kw)`` (the kernel takes contiguous operands), features
    channel-major ``(c, kh, kw)`` with symmetric zero padding."""
    B, H, W, _ = x.shape
    ho = (H + 2 * padding - kernel) // stride + 1
    wo = (W + 2 * padding - kernel) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding,
                    stride=stride)                       # (B, C*kh*kw, L)
    return cols.transpose(1, 2).reshape(B, ho, wo,
                                        cols.shape[1]).contiguous()


def quant_cnn_apply(qparams, cfg: CNNConfig, x: torch.Tensor,
                    masks: Optional[Dict[int, torch.Tensor]] = None,
                    start_layer: int = 0, stop_layer: Optional[int] = None,
                    backend: str = "ref") -> torch.Tensor:
    """``models.cnn.cnn_apply`` with conv/dense dispatched through the
    masked GEMM over a ``quantize_params`` bank. The channel mask rides in
    the kernel's epilogue and the bias is added pre-masked (``b * mask``),
    so the result matches ``(conv(x) + b) * mask``."""
    masks = masks or {}
    stop = stop_layer if stop_layer is not None else len(cfg.layers)
    for i in range(start_layer, stop):
        spec = cfg.layers[i]
        if spec.kind in ("conv", "dense"):
            lp = qparams[f"l{i}"]
            if spec.kind == "conv":
                x = im2col_nhwc(x, spec.kernel, spec.stride, spec.padding)
            mvec = (masks[i].to(torch.float32) if i in masks
                    else torch.ones(lp["b"].shape[0], dtype=torch.float32,
                                    device=lp["b"].device))
            x = _gemm(x, lp, mvec, backend) + lp["b"] * mvec
        elif spec.kind == "relu":
            x = torch.relu(x)
        elif spec.kind == "maxpool":
            x = maxpool_nhwc(x, spec)
        elif spec.kind == "flatten":
            x = x.reshape(x.shape[0], -1)
    return x


# ---------------------------------------------------------------------------
# kernel-cost calibration (feeds latency_model.KernelCalibration)
# ---------------------------------------------------------------------------
def calibrate_quant_edge(qparams, cfg: CNNConfig, x,
                         masks: Optional[Dict[int, torch.Tensor]] = None,
                         backend: str = "auto", repeats: int = 3,
                         device: DeviceLike = None):
    """Time the deployed quantized edge layer by layer on ``device`` (the
    card unless the caller names another) -> a ``KernelCalibration`` whose
    ``layer_s`` plugs into ``sweep_splits(..., measured_device_s=...)``
    (Algorithm 1 line 22's timestamp hook, over the deployed kernels).

    ``qparams`` is the ``quantize_params`` bank of the deployed network
    ``cfg`` (moved to ``device`` here); each layer runs alone through
    ``quant_cnn_apply(start_layer=i, stop_layer=i + 1)``, so on the card
    every conv and dense layer launches ``masked_matmul_q8`` (the float32
    kernel for a ``weight_bits=None`` bank) on the route its shape picks,
    once untimed and ``repeats`` times timed. ``backend="auto"`` is the
    kernel on the card and the plain GEMM on the CPU."""
    dev = resolve_device(device)
    if backend == "auto":
        backend = "pallas" if dev.type == "cuda" else "ref"
    qp = {k: {n: t.to(dev) for n, t in v.items()}
          for k, v in qparams.items()}
    tmasks = masks_to(masks, dev)
    fns = [lambda v, s=i: quant_cnn_apply(qp, cfg, v, masks=tmasks,
                                          start_layer=s, stop_layer=s + 1,
                                          backend=backend)
           for i in range(len(cfg.layers))]
    x0 = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                         else x).to(dev)
    return KernelCalibration.measure(fns, x0, repeats=repeats)
