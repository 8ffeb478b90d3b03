"""Per-layer cost model + the collaborative-inference latency of Eq. 5
(the CNN and transformer arithmetic of the JAX package's
``core/partition/latency_model.py``):

    T(c) = T_D(c) + T_TX(c) + T_S(c)

Split point ``c`` means layers [0, c) run on the device and [c, N) on the
server; c = N is device-only, c = 0 is server-only (the raw input is
transmitted instead). Per-layer FLOPs and activation bytes come from the
layer specs; pruning shrinks both. Plain Python arithmetic, identical to
the reference's, so both packages pick the same split.

Measured per-layer times (Algorithm 1 line 22, "via timestamps") replace
the analytic device or server terms when given: ``KernelCalibration``
times any per-layer forward (``measure_cnn_layer_times`` the fp32 layers
on cuDNN and cuBLAS, ``core.collab.quant.calibrate_quant_edge`` the
deployed quantized edge), and its ``layer_s`` plugs into
``split_latency`` / ``sweep_splits`` as ``measured_device_s``. On the card
a layer's time is what one request pays for it, host enqueue included:
CUDA events around each call, the device idle before it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig, ModelConfig
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.partition.profiles import TwoTierProfile
from repro_torch.device import DeviceLike, exact_fp32, resolve_device
from repro_torch.models.cnn import (compact_cnn_config, layer_shapes,
                                    masks_to, oihw_params, run_layers,
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


def quantized_cnn_layer_costs(cfg: CNNConfig, masks=None,
                              weight_bits: Optional[int] = 8,
                              bytes_per_elem: int = 4) -> List[LayerCost]:
    """Price the *quantized* deployed network: compacted shapes with
    ``params_bytes`` scaled to the quantized weight width (the weight
    traffic an int8/int4 edge streams per inference). FLOPs and
    activation bytes are unchanged (weight-only quantization keeps fp32
    activations); ``weight_bits=None`` prices the fp32 weights."""
    costs = compacted_cnn_layer_costs(cfg, masks, bytes_per_elem)
    if weight_bits is None:
        return costs
    frac = weight_bits / (8.0 * bytes_per_elem)
    return [LayerCost(c.index, c.name, c.flops, c.out_bytes,
                      c.params_bytes * frac) for c in costs]


# ---------------------------------------------------------------------------
# analytic costs: transformer (per decoder layer, batch=1)
# ---------------------------------------------------------------------------
def transformer_layer_costs(cfg: ModelConfig, seq_len: int,
                            bytes_per_elem: int = 2,
                            decode: bool = False) -> List[LayerCost]:
    """One ``LayerCost`` a decoder layer of ``cfg`` at batch 1: its
    forward FLOPs over ``seq_len`` tokens (one token against a
    ``seq_len`` context when ``decode``) and the bytes of its output.
    GQA projections and attention over the (windowed) context, or MLA's
    low-rank projections; an FFN, or ``top_k + num_shared`` experts plus
    the router; an SSM layer's projections, SSD term and out-projection.
    The reference's arithmetic in its order, so both packages give the
    same list and pick the same split."""
    d = cfg.d_model
    S = 1 if decode else seq_len
    ctx = seq_len
    costs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        fl = 0.0
        if kind in ("attn", "attn_dense", "moe"):
            if cfg.attention == "mla":
                m = cfg.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                proj = (d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * cfg.num_heads
                        * (m.qk_nope_head_dim + m.v_head_dim)
                        + cfg.num_heads * m.v_head_dim * d)
                att = cfg.num_heads * ctx * (qk + m.v_head_dim)
            else:
                proj = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
                win = min(ctx, cfg.sliding_window or ctx)
                att = cfg.num_heads * win * 2 * cfg.head_dim
            fl += 2.0 * S * (proj + att)
            mult = 3 if cfg.activation in ("silu_glu", "geglu") else 2
            if kind == "moe":
                m = cfg.moe
                fl += 2.0 * S * (m.top_k + m.num_shared) * d * m.d_expert * mult
                fl += 2.0 * S * d * m.num_experts     # router
            else:
                fl += 2.0 * S * d * cfg.d_ff * mult
        elif kind == "ssm":
            s = cfg.ssm
            d_in = cfg.d_inner
            proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + cfg.ssm_heads)
            ssd = d_in * s.d_state * 6
            fl += 2.0 * S * (proj + ssd + d_in * d)
        costs.append(LayerCost(i, f"{kind}{i}", fl, S * d * bytes_per_elem))
    return costs


# ---------------------------------------------------------------------------
# measured costs (Algorithm 1, line 22: "via timestamps")
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class KernelCalibration:
    """Measured per-layer edge seconds, the kernel-cost calibration hook of
    the split model: ``layer_s`` plugs into ``split_latency`` /
    ``sweep_splits`` / ``energy_aware_split`` as ``measured_device_s``, so
    the sweep picks splits on the deployed kernels' costs instead of the
    analytic roofline."""
    layer_s: tuple

    @classmethod
    def measure(cls, layer_fns: Sequence, x0,
                repeats: int = 3) -> "KernelCalibration":
        """``layer_fns[i]`` maps layer i's input to its output; outputs
        thread forward, so each layer is timed on its real input. Each
        layer runs once untimed (its first call meets its shapes), then
        ``repeats`` times, and its time is the mean. On a CUDA tensor each
        call is timed by CUDA events with the device idle before it (a
        synchronize ahead of the start event), which is what one request
        pays for the layer, host enqueue included; on the CPU by the host
        clock. Calls run in inference mode with full fp32, as the serving
        path runs them."""
        cuda = torch.is_tensor(x0) and x0.device.type == "cuda"
        times = []
        cur = x0
        with torch.inference_mode(), exact_fp32():
            for fn in layer_fns:
                out = fn(cur)
                total = 0.0
                for _ in range(repeats):
                    if cuda:
                        torch.cuda.synchronize(x0.device)
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        fn(cur)
                        end.record()
                        end.synchronize()
                        total += start.elapsed_time(end) / 1e3
                    else:
                        t0 = time.perf_counter()
                        fn(cur)
                        total += time.perf_counter() - t0
                times.append(float(total / repeats))
                cur = out
        return cls(tuple(times))

    def total_s(self, split: Optional[int] = None) -> float:
        """Measured device seconds for layers [0, split) (all when None)."""
        n = len(self.layer_s) if split is None else split
        return float(sum(self.layer_s[:n]))


def _params_on(params, device: torch.device):
    """A params dict (numpy arrays or tensors) as float tensors on
    ``device``."""
    return {k: {n: torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                                   else t).to(device)
                for n, t in v.items()} for k, v in params.items()}


def measure_cnn_layer_times(params, cfg: CNNConfig, x, masks=None,
                            repeats: int = 3,
                            device: DeviceLike = None) -> List[float]:
    """Seconds per layer of the fp32 network (convolutions on cuDNN,
    dense layers on cuBLAS, TF32 off) on ``device``, the card unless the
    caller names another, each layer timed by
    ``KernelCalibration.measure``."""
    dev = resolve_device(device)
    tparams = oihw_params(_params_on(params, dev), cfg)
    tmasks = masks_to(masks, dev)
    fns = [lambda v, s=i: run_layers(tparams, cfg, v, masks=tmasks,
                                     start_layer=s, stop_layer=s + 1)
           for i in range(len(cfg.layers))]
    x0 = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                         else x).to(dev)
    return list(KernelCalibration.measure(fns, x0, repeats=repeats).layer_s)


def cnn_layer_output_bytes(params, cfg: CNNConfig, x,
                           masks=None) -> List[int]:
    """True transmitted payload per split point: the surviving units only
    (pruned channels are zeros under masked execution and absent after
    compaction), per batch row. Runs ``run_layers`` where the parameters
    lie (numpy parameters on the CPU)."""
    leaf = next(iter(params.values()))["w"]
    dev = leaf.device if torch.is_tensor(leaf) else torch.device("cpu")
    tp = oihw_params(_params_on(params, dev), cfg)
    xt = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                         else x).to(dev)
    with torch.inference_mode(), exact_fp32():
        _, inter = run_layers(tp, cfg, xt, masks=masks_to(masks, dev),
                              return_intermediates=True)
    masks = masks or {}
    out = []
    keep = 1.0
    for i, a in enumerate(inter):
        if i in masks:
            keep = float(np.mean(np.asarray(masks[i])))
        # relu/pool/flatten inherit the producer's surviving-channel ratio
        nbytes = a.numel() * a.element_size()
        out.append(int(nbytes / a.shape[0] * keep if keep < 1.0
                       else nbytes / a.shape[0]))
    return out


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


def batched_segment_time(costs: Sequence[LayerCost], start: int, stop: int,
                         comp, batch: int) -> float:
    """Analytic time for ONE invocation running layers ``[start, stop)``
    over ``batch`` fused rows on ``comp`` (a ``ComputeProfile``) — the
    same per-layer roofline + once-per-call overhead formula as
    ``split_latency``, exposed for *partial* stacks: the fleet
    simulator's cloudlet tier runs ``[c1, c2)`` and its cloud tier
    ``[c2, N)``, both priced here so tier numbers can never drift from
    the two-tier model."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    if not 0 <= start <= stop <= len(costs):
        raise ValueError(f"segment [{start}, {stop}) outside "
                         f"[0, {len(costs)}]")
    return _segment_time(costs, range(start, stop), comp, batch)


def batched_server_time(costs: Sequence[LayerCost], c: int,
                        server, batch: int) -> float:
    """Analytic T_S for ONE cloud invocation serving ``batch`` fused
    requests on ``server`` (a ``ComputeProfile``): per-layer FLOPs and
    activation traffic scale with the batch, but the per-invocation
    constant (``ComputeProfile.overhead_s`` — kernel launch, dispatch,
    framework overhead) is paid once per *batch* instead of once per
    *request*. The gap between ``batch * batched_server_time(..., 1)``
    and ``batched_server_time(..., batch)`` is exactly the throughput
    headroom the cross-client dynamic batching engine recovers; per
    request it approaches ``overhead_s``-free compute as the batching
    window fills."""
    return batched_segment_time(costs, c, len(costs), server, batch)


def split_latency(costs: Sequence[LayerCost], c: int,
                  profile: TwoTierProfile,
                  input_bytes: float,
                  measured_device_s: Optional[Sequence[float]] = None,
                  measured_server_s: Optional[Sequence[float]] = None,
                  tx_scale: float = 1.0,
                  round_trip: bool = False) -> Dict[str, float]:
    """Latency breakdown for split point c (layers [0,c) on device).
    ``measured_device_s`` / ``measured_server_s`` (seconds per layer, e.g.
    ``KernelCalibration.layer_s``) replace the analytic segment times.
    T_TX charges the uplink feature tensor plus one RTT (the paper's
    Eq. 5); ``round_trip=True`` adds the logits downlink and a second
    RTT. ``tx_bytes`` stays uplink-only."""
    n = len(costs)
    if not 0 <= c <= n:
        raise ValueError(f"split {c} outside [0, {n}]")

    def seg_time(idx, comp, measured):
        if measured is not None:
            return sum(measured[i] for i in idx)
        return _segment_time(costs, idx, comp)

    t_d = seg_time(range(c), profile.device, measured_device_s)
    t_s = seg_time(range(c, n), profile.server, measured_server_s)
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
