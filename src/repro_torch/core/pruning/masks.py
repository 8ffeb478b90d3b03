"""Structured pruning masks — the actuator of the pruning policy.

The paper prunes conv channels of AlexNet. The reference generalizes the
action "keep fraction a of layer i's structured units" to every family;
the port has the CNN case, the dense and MoE transformers' axes and the SSD
heads:

  CNN         conv out-channels / dense units        (the paper's case)
  dense attn  attention heads (whole GQA groups) + FFN inner channels
  MoE         attention heads (whole GQA groups) + whole experts
  MLA         single heads (no KV groups), by |w_uv|; dense layers' FFN
              channels, MoE layers' experts
  SSD         ssm heads

Importance ranking is L1 weight magnitude (as in AMC): the kept units are
the top-a fraction by importance, emitted as 0/1 float32 masks. The
importance vector is computed on the parameters' device, then ranked on
the host with numpy exactly as the reference ranks it
(``np.argsort(-importance)``), so both packages keep the same units.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig, ModelConfig
from repro_torch.models.transformer import check_supported, layer_runs


def _topk_mask(importance: np.ndarray, keep_ratio: float,
               min_keep: int = 1) -> np.ndarray:
    n = importance.shape[0]
    k = max(min_keep, int(round(keep_ratio * n)))
    k = min(k, n)
    keep = np.argsort(-importance)[:k]
    m = np.zeros(n, np.float32)
    m[keep] = 1.0
    return m


def _l1(w: torch.Tensor, dims) -> np.ndarray:
    """float32 L1 magnitude of ``w`` summed over ``dims``, on w's device,
    returned to the host. The magnitudes stay in w's dtype (exact) and are
    summed in float32, so a bf16 tensor gets no float32 copy (DeepSeek-V3's
    ``w_down`` of one MoE layer would take 15 GB)."""
    return w.abs().sum(dims, dtype=torch.float32).cpu().numpy()


# ---------------------------------------------------------------------------
# CNN (paper-faithful)
# ---------------------------------------------------------------------------
def cnn_layer_importance(params, cfg: CNNConfig, layer: int) -> np.ndarray:
    w = params[f"l{layer}"]["w"]
    if w.dim() == 4:     # (kh, kw, cin, cout)
        return _l1(w, (0, 1, 2))
    return _l1(w, 0)     # dense (din, dout)


def cnn_masks_from_ratios(params, cfg: CNNConfig,
                          ratios: Dict[int, float]) -> Dict[int, torch.Tensor]:
    masks = {}
    for layer, a in ratios.items():
        imp = cnn_layer_importance(params, cfg, layer)
        masks[layer] = torch.from_numpy(_topk_mask(imp, float(a))).to(
            params[f"l{layer}"]["w"].device)
    return masks


# ---------------------------------------------------------------------------
# transformer families
# ---------------------------------------------------------------------------
def transformer_prunable_units(cfg: ModelConfig) -> List[Dict]:
    """One entry per (layer, axis) the agent controls, in layer order.

    Each entry: {run, layer_in_run, layer, axis, n_units}."""
    check_supported(cfg)
    units = []
    for r_idx, run in enumerate(layer_runs(cfg)):
        for j in range(run.count):
            layer = run.start + j
            if run.kind == "ssm":
                units.append(dict(run=r_idx, layer_in_run=j, layer=layer,
                                  axis="ssm_head_mask",
                                  n_units=cfg.ssm_heads))
                continue
            units.append(dict(run=r_idx, layer_in_run=j, layer=layer,
                              axis="head_mask", n_units=cfg.num_heads))
            if run.kind == "moe":
                units.append(dict(run=r_idx, layer_in_run=j, layer=layer,
                                  axis="expert_mask",
                                  n_units=cfg.moe.num_experts))
            else:
                units.append(dict(run=r_idx, layer_in_run=j, layer=layer,
                                  axis="ffn_mask", n_units=cfg.d_ff))
    return units


def _axis_importance(params, cfg: ModelConfig, unit: Dict) -> np.ndarray:
    rp = params["runs"][unit["run"]]
    j = unit["layer_in_run"]
    axis = unit["axis"]
    if axis == "head_mask":
        if cfg.attention == "mla":
            w = rp["attn"]["w_uv"][j]                 # (rank, H*vd)
            return _l1(w.reshape(w.shape[0], cfg.num_heads, -1), (0, 2))
        w = rp["attn"]["wo"][j]                       # (H*D, d)
        return _l1(w.reshape(cfg.num_heads, -1), 1)
    if axis == "ffn_mask":
        return _l1(rp["mlp"]["w_down"][j], 1)         # (dff, d)
    if axis == "expert_mask":
        return _l1(rp["moe"]["w_down"][j], (1, 2))    # (E, de, d)
    if axis == "ssm_head_mask":
        w = rp["ssm"]["w_out"][j]                     # (d_in, d)
        return _l1(w.reshape(cfg.ssm_heads, cfg.ssm.head_dim, -1), (1, 2))
    raise ValueError(axis)


def transformer_masks_from_ratios(params, cfg: ModelConfig,
                                  ratios: List[float],
                                  min_keep: Optional[Dict[str, int]] = None
                                  ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """ratios[k] is the preserve ratio for transformer_prunable_units()[k].

    Returns the per-run mask structure ``forward``/``decode_step`` accept:
    a list (one per run) of dicts axis -> (count, n_units) stacked float32
    masks on the parameters' device. GQA head masks keep whole KV groups
    intact (kv-head multiples) so the grouped attention layout survives
    pruning; MLA's heads share no KV group and are kept one by one. An
    expert mask keeps at least ``top_k + num_shared`` experts
    unless ``min_keep`` says otherwise, as the reference's does."""
    units = transformer_prunable_units(cfg)
    assert len(ratios) == len(units), (len(ratios), len(units))
    min_keep = min_keep or {}
    device = params["embed"].device
    out: List[Optional[Dict[str, torch.Tensor]]] = []
    for r_idx, run in enumerate(layer_runs(cfg)):
        axes: Dict[str, np.ndarray] = {}
        for unit, a in zip(units, ratios):
            if unit["run"] != r_idx:
                continue
            imp = _axis_importance(params, cfg, unit)
            if unit["axis"] == "head_mask" and cfg.attention != "mla":
                # prune whole GQA groups: average importance per group,
                # then expand back to heads
                g = cfg.num_heads // cfg.num_kv_heads
                gi = imp.reshape(cfg.num_kv_heads, g).mean(1)
                gm = _topk_mask(gi, float(a), min_keep.get("head_mask", 1))
                m = np.repeat(gm, g)
            else:
                floor = (cfg.moe.top_k + cfg.moe.num_shared
                         if unit["axis"] == "expert_mask" else 1)
                m = _topk_mask(imp, float(a),
                               min_keep.get(unit["axis"], floor))
            axes.setdefault(unit["axis"],
                            np.zeros((run.count, unit["n_units"]),
                                     np.float32))[unit["layer_in_run"]] = m
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in axes.items()} if axes else None)
    return out


def mask_sparsity(masks) -> float:
    """Fraction of units removed across all masks (a list of per-run dicts
    or a dict of per-layer masks, of tensors or arrays)."""
    tot = kept = 0

    def walk(tree):
        nonlocal tot, kept
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif tree is not None:
            arr = (tree.detach().cpu().numpy() if torch.is_tensor(tree)
                   else np.asarray(tree))
            tot += arr.size
            kept += arr.sum()

    walk(masks)
    return 1.0 - kept / max(tot, 1)
