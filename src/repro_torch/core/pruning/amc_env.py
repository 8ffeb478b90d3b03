"""AMC-style pruning environment (paper §3.2, Eq. 1).

The environment walks the prunable layers of a model; the agent emits a
preserve ratio a_i per layer. State s_i is the Eq. 1 descriptor

    (i, n, c, h, w, stride, k, FLOPs[i], F_rdc, F_rest, a_{i-1})

normalized feature-wise to [0, 1]. Actions are clipped AMC-style so the
episode can always still reach the global FLOPs budget: at layer i the
maximum allowed preserve ratio is the one that — even if every later layer
is pruned to its floor — keeps total FLOPs within budget.

The environment is model-agnostic: it takes a list of LayerDesc and an
``evaluate(ratios) -> accuracy`` callback, so the same machinery prunes the
paper's AlexNet and any assigned transformer (see masks.py for the unit
mapping).

A copy of the JAX package's ``core/pruning/amc_env.py`` (numpy only), on
the port's ``layer_shapes``, ``prunable_layers`` and
``masks.transformer_prunable_units``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.configs.base import CNNConfig, ModelConfig
from repro_torch.models.cnn import layer_shapes, prunable_layers

STATE_DIM = 11


@dataclass
class LayerDesc:
    index: int
    n: int            # out units
    c: int            # in units
    h: int
    w: int
    stride: int
    k: int
    flops: float
    in_coupled: bool = True   # does pruning layer i-1 shrink this layer's input?


def cnn_layer_descs(cfg: CNNConfig) -> List[LayerDesc]:
    shapes = layer_shapes(cfg)
    descs = []
    c_in = cfg.input_channels
    h_in, w_in = cfg.input_hw
    flat_in = None
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            c_out, h, w = shapes[i]
            fl = 2.0 * h * w * c_out * c_in * spec.kernel ** 2
            descs.append(LayerDesc(i, c_out, c_in, h, w, spec.stride,
                                   spec.kernel, fl))
            c_in, h_in, w_in = c_out, h, w
        elif spec.kind in ("maxpool",):
            c_in, h_in, w_in = shapes[i]
        elif spec.kind == "flatten":
            flat_in = shapes[i][0]
        elif spec.kind == "dense":
            d_in = flat_in if flat_in is not None else shapes[i - 1][0]
            fl = 2.0 * d_in * spec.features
            descs.append(LayerDesc(i, spec.features, d_in, 1, 1, 1, 1, fl))
            flat_in = spec.features
    keep = set(prunable_layers(cfg))
    return [d for d in descs if d.index in keep]


def transformer_layer_descs(cfg: ModelConfig, seq_len: int = 512
                            ) -> List[LayerDesc]:
    """LayerDesc per prunable (layer, axis) unit — matches
    masks.transformer_prunable_units ordering."""
    from repro_torch.core.pruning.masks import transformer_prunable_units
    descs = []
    d = cfg.d_model
    for idx, u in enumerate(transformer_prunable_units(cfg)):
        if u["axis"] == "head_mask":
            per_head = cfg.head_dim if cfg.attention != "mla" else (
                cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
                + cfg.mla.v_head_dim)
            fl = 2.0 * seq_len * (2 * d * per_head * u["n_units"]
                                  + 2 * seq_len * per_head * u["n_units"])
            descs.append(LayerDesc(idx, u["n_units"], d, seq_len, 1, 1, 1,
                                   fl, in_coupled=False))
        elif u["axis"] == "ffn_mask":
            mult = 3 if cfg.activation in ("silu_glu", "geglu") else 2
            fl = 2.0 * seq_len * d * u["n_units"] * mult
            descs.append(LayerDesc(idx, u["n_units"], d, seq_len, 1, 1, 1,
                                   fl, in_coupled=False))
        elif u["axis"] == "expert_mask":
            m = cfg.moe
            mult = 3 if cfg.activation in ("silu_glu", "geglu") else 2
            fl = 2.0 * seq_len * m.top_k * d * m.d_expert * mult
            descs.append(LayerDesc(idx, u["n_units"], d, seq_len, 1, 1, 1,
                                   fl, in_coupled=False))
        elif u["axis"] == "ssm_head_mask":
            s = cfg.ssm
            fl = 2.0 * seq_len * (2 * d * s.head_dim * u["n_units"]
                                  + s.head_dim * u["n_units"] * s.d_state * 4)
            descs.append(LayerDesc(idx, u["n_units"], d, seq_len, 1, 1, 1,
                                   fl, in_coupled=False))
    return descs


class PruningEnv:
    """Episode = one pass over prunable layers."""

    def __init__(self, descs: Sequence[LayerDesc],
                 evaluate: Callable[[List[float]], float],
                 flops_budget: float = 0.5,
                 action_floor: float = 0.1):
        self.descs = list(descs)
        self.evaluate = evaluate
        self.budget = flops_budget
        self.floor = action_floor
        self.total_flops = sum(d.flops for d in self.descs)
        self._norm = self._feature_norms()

    def _feature_norms(self) -> np.ndarray:
        feats = np.array([[d.index, d.n, d.c, d.h, d.w, d.stride, d.k,
                           d.flops, self.total_flops, self.total_flops, 1.0]
                          for d in self.descs], np.float32)
        return np.maximum(feats.max(0), 1e-9)

    def state(self, i: int, f_rdc: float, f_rest: float,
              a_prev: float) -> np.ndarray:
        d = self.descs[i]
        raw = np.array([d.index, d.n, d.c, d.h, d.w, d.stride, d.k,
                        d.flops, f_rdc, f_rest, a_prev], np.float32)
        return raw / self._norm

    def clip_action(self, i: int, a: float, f_rdc: float) -> float:
        """AMC resource-constrained clipping: keep the budget reachable."""
        d = self.descs[i]
        f_rest = sum(x.flops for x in self.descs[i + 1:])
        # best case: later layers pruned to floor
        rest_min = f_rest * self.floor
        target = self.budget * self.total_flops
        # flops kept so far + a*f_i + rest_min <= target  =>  a <= a_max
        kept_so_far = sum(x.flops for x in self.descs[:i]) - f_rdc
        a_max = (target - kept_so_far - rest_min) / max(d.flops, 1e-9)
        return float(np.clip(a, self.floor, max(self.floor, min(1.0, a_max))))

    def run_episode(self, act: Callable[[np.ndarray, int], float]
                    ) -> Dict:
        """act(state, layer_index) -> raw action. Returns episode record."""
        f_rdc = 0.0
        a_prev = 1.0
        states, actions = [], []
        for i, d in enumerate(self.descs):
            f_rest = sum(x.flops for x in self.descs[i + 1:])
            s = self.state(i, f_rdc, f_rest, a_prev)
            a = self.clip_action(i, float(act(s, i)), f_rdc)
            states.append(s)
            actions.append(a)
            in_ratio = a_prev if d.in_coupled else 1.0
            f_rdc += d.flops * (1.0 - a * in_ratio)
            a_prev = a
        acc = float(self.evaluate(actions))
        kept = 1.0 - f_rdc / self.total_flops
        # terminal next-state: zeros
        next_states = states[1:] + [np.zeros(STATE_DIM, np.float32)]
        return {"states": states, "actions": actions, "reward": acc,
                "flops_kept": kept, "next_states": next_states}
