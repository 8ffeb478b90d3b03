"""Per-layer cost model + the collaborative-inference latency of Eq. 5
(the CNN arithmetic of the JAX package's ``core/partition/latency_model.py``):

    T(c) = T_D(c) + T_TX(c) + T_S(c)

Split point ``c`` means layers [0, c) run on the device and [c, N) on the
server; c = N is device-only, c = 0 is server-only (the raw input is
transmitted instead). Per-layer FLOPs and activation bytes come from the
layer specs; pruning shrinks both. Plain Python arithmetic, identical to
the reference's, so both packages pick the same split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.partition.profiles import TwoTierProfile
from repro_torch.models.cnn import (compact_cnn_config, layer_shapes,
                                    split_keep_indices)


@dataclass
class LayerCost:
    index: int
    name: str
    flops: float                # forward FLOPs for batch=1
    out_bytes: float            # activation bytes crossing a split AFTER it
    params_bytes: float = 0.0


def cnn_layer_costs(cfg: CNNConfig,
                    masks: Optional[Dict[int, np.ndarray]] = None,
                    bytes_per_elem: int = 4) -> List[LayerCost]:
    shapes = layer_shapes(cfg)
    masks = masks or {}
    costs = []
    c_in = cfg.input_channels
    keep_in = 1.0
    flat = None
    for i, spec in enumerate(cfg.layers):
        keep_out = (float(np.mean(np.asarray(masks[i]))) if i in masks
                    else 1.0)
        if spec.kind == "conv":
            c_out, h, w = shapes[i]
            fl = 2.0 * h * w * c_out * c_in * spec.kernel ** 2
            fl *= keep_in * keep_out
            ob = h * w * c_out * keep_out * bytes_per_elem
            pb = (spec.kernel ** 2 * c_in * c_out * keep_in * keep_out
                  + c_out * keep_out) * bytes_per_elem
            costs.append(LayerCost(i, f"conv{i}", fl, ob, pb))
            c_in = c_out
            keep_in = keep_out
        elif spec.kind == "relu":
            shp = shapes[i]
            nelem = int(np.prod(shp)) * keep_in
            costs.append(LayerCost(i, f"relu{i}", nelem,
                                   nelem * bytes_per_elem))
        elif spec.kind == "maxpool":
            c, h, w = shapes[i]
            nelem = c * h * w * keep_in
            costs.append(LayerCost(i, f"pool{i}",
                                   nelem * spec.kernel ** 2,
                                   nelem * bytes_per_elem))
        elif spec.kind == "flatten":
            nelem = shapes[i][0] * keep_in
            costs.append(LayerCost(i, f"flat{i}", 0.0,
                                   nelem * bytes_per_elem))
        elif spec.kind == "dense":
            d_in = (flat if flat is not None else shapes[i - 1][0])
            fl = 2.0 * d_in * spec.features * keep_in * keep_out
            ob = spec.features * keep_out * bytes_per_elem
            pb = (d_in * spec.features * keep_in * keep_out
                  + spec.features * keep_out) * bytes_per_elem
            costs.append(LayerCost(i, f"fc{i}", fl, ob, pb))
            keep_in = keep_out
            flat = spec.features
    return costs


def cnn_input_bytes(cfg: CNNConfig, bytes_per_elem: int = 4) -> float:
    h, w = cfg.input_hw
    return h * w * cfg.input_channels * bytes_per_elem


def compacted_cnn_layer_costs(cfg: CNNConfig, masks,
                              bytes_per_elem: int = 4) -> List[LayerCost]:
    """Price the *deployed* network: pruned channels physically removed
    (``compact_cnn_config``)."""
    return cnn_layer_costs(compact_cnn_config(cfg, masks or {}),
                           bytes_per_elem=bytes_per_elem)


def wire_tx_scale(cfg: CNNConfig, masks, split: int,
                  codec: Optional[str] = None, pack: bool = False,
                  compact: bool = False) -> float:
    """The ``tx_scale`` that makes the analytic ``tx_bytes`` equal the
    deployed runtime's wire payload at ``split``: the codec's bytes per
    element relative to fp32, times the packing correction (a
    masked-but-dense deployment without packing ships the dead channels
    too, so the keep-discounted cost is un-discounted). Frame headers are
    not modelled."""
    scale = CODEC_TX_SCALE[codec or "fp32"]
    if compact or not masks or split <= 0:
        return scale
    keep = split_keep_indices(cfg, masks, split)
    if keep is None or pack:
        return scale
    n_full = layer_shapes(cfg)[split - 1][0]
    return scale * n_full / keep.size


def _segment_time(costs: Sequence[LayerCost], idx, comp,
                  batch: int = 1) -> float:
    """Per-layer roofline (flops vs activation traffic) scaled by the batch
    plus the per-invocation overhead, paid once per layer per call."""
    t = 0.0
    for i in idx:
        work = max(batch * costs[i].flops / comp.flops_per_s,
                   2 * batch * costs[i].out_bytes / comp.mem_bw)
        t += work + comp.overhead_s
    return t


def split_latency(costs: Sequence[LayerCost], c: int,
                  profile: TwoTierProfile,
                  input_bytes: float,
                  tx_scale: float = 1.0,
                  round_trip: bool = False) -> Dict[str, float]:
    """Latency breakdown for split point c (layers [0,c) on device).
    T_TX charges the uplink feature tensor plus one RTT (the paper's
    Eq. 5); ``round_trip=True`` adds the logits downlink and a second
    RTT. ``tx_bytes`` stays uplink-only."""
    n = len(costs)
    if not 0 <= c <= n:
        raise ValueError(f"split {c} outside [0, {n}]")
    t_d = _segment_time(costs, range(c), profile.device)
    t_s = _segment_time(costs, range(c, n), profile.server)
    tx_bytes = (input_bytes if c == 0 else costs[c - 1].out_bytes) * tx_scale
    if c == n:
        t_tx = 0.0
    else:
        t_tx = tx_bytes / profile.link.bandwidth + profile.link.rtt_s
        if round_trip:
            t_tx += (costs[n - 1].out_bytes / profile.link.bandwidth
                     + profile.link.rtt_s)
    return {"T_D": t_d, "T_TX": t_tx, "T_S": t_s,
            "T": t_d + t_tx + t_s, "tx_bytes": 0.0 if c == n else tx_bytes}
