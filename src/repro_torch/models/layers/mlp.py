"""Feed-forward blocks: gated (SiLU-GLU / GeGLU) and non-gated (GELU /
squared-ReLU, the Nemotron-4 variant).

Pruning hook: ``ffn_mask`` (d_ff,) zeroes pruned inner channels — the
structured axis the pruner controls for FFN layers. With a mask, the up
and gate products go through the column-masked GEMM (``kernels
.masked_matmul``: the CUDA kernel on the card, its plain version on the
CPU or with ``backend="ref"``), as the reference's Pallas path does; the
down product is a plain matrix product outside any kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch.models.layers.init import normal, slot

GATED = {"silu_glu", "geglu"}


def _init(gen: torch.Generator, shape, dtype, device,
          out=None) -> torch.Tensor:
    return normal(gen, shape, dtype, device, div=math.sqrt(shape[0]),
                  out=out)


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    activation: str, dtype: torch.dtype,
                    device: torch.device,
                    out=None) -> Dict[str, torch.Tensor]:
    """Normal weights scaled by 1/sqrt(fan_in), as the reference draws
    them (from ``gen``, so the numbers are the port's own), each into its
    slot of ``out`` where given (``layers.init``)."""
    p = {"w_up": _init(gen, (d_model, d_ff), dtype, device,
                       slot(out, "w_up")),
         "w_down": _init(gen, (d_ff, d_model), dtype, device,
                         slot(out, "w_down"))}
    if activation in GATED:
        p["w_gate"] = _init(gen, (d_model, d_ff), dtype, device,
                            slot(out, "w_gate"))
    return p


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu_glu":
        return F.silu(x)
    if activation in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if activation == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(activation)


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                activation: str, *, ffn_mask: Optional[torch.Tensor] = None,
                backend: str = "auto", tp=None) -> torch.Tensor:
    """x (..., d_model) -> (..., d_model). With ``tp`` (a
    ``sharding.tensor_parallel.TensorParallel``) ``params`` and
    ``ffn_mask`` hold the rank's FFN columns and the down product's
    partial sum is reduced over "model"."""
    if tp is not None:
        x = tp.copy_in(x)
    if ffn_mask is not None:
        mm = masked_matmul_ref if backend == "ref" else masked_matmul
        h = _act(mm(x, params["w_up"], ffn_mask), activation)
        if activation in GATED:
            h = h * mm(x, params["w_gate"], ffn_mask)
    else:
        h = _act(x @ params["w_up"], activation)
        if activation in GATED:
            h = h * (x @ params["w_gate"])
    out = h @ params["w_down"]
    return out if tp is None else tp.reduce(out)
