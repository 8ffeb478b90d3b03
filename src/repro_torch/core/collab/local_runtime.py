"""In-process split executor: the local half of the JAX package's
``core/collab/runtime.py`` (``RequestTiming``, ``deploy_submodels``, a
batch-1 ``SplitFnBank`` and ``CollabRunner``).

Edge submodel -> (simulated) channel -> cloud submodel, on one device. The
edge half runs the quantized kernel path (``quant.quant_cnn_apply``) when
the plan carries a ``quant`` section, else the fp32 layers; the cloud half
is always fp32 (``models.cnn.run_layers``). The split-boundary tensor is
really encoded with the wire codec, charged on the ``SimChannel`` and
decoded, so ``tx_bytes`` is the true frame size and a lossy codec has its
true numerical effect.

Both halves run inside ``device.exact_fp32()``: cuDNN would otherwise run
the fp32 convolutions in TF32. Wall-clock around each half ends in
``torch.cuda.synchronize()`` on a card.

The module lives beside the future ``runtime.py`` rather than in it: the
repository's static analysis gate matches ``core/collab/runtime.py`` by
path and expects the socket executor's state there, so the socket slice
folds this file into ``runtime.py`` when it ports the whole.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.channel import SimChannel
from repro_torch.core.collab.protocol import decode_any, encode_feature
from repro_torch.core.collab.quant import (QuantPolicy, quant_cnn_apply,
                                           quantize_params, resolve_backend)
from repro_torch.core.partition.latency_model import (
    cnn_input_bytes, cnn_layer_costs, compacted_cnn_layer_costs,
    split_latency, wire_tx_scale)
from repro_torch.core.partition.profiles import TwoTierProfile
from repro_torch.device import (DeviceLike, exact_fp32, resolve_device,
                                synchronize)
from repro_torch.models.cnn import (compact_params, masks_to, oihw_params,
                                    run_layers, split_keep_indices)


@dataclass
class RequestTiming:
    """Per-request accounting: ``t_*`` in seconds, ``tx_bytes`` the
    transmitted frame payload in bytes."""
    t_device: float
    t_tx: float
    t_server: float
    tx_bytes: int


def deploy_submodels(params, cfg: CNNConfig, masks=None,
                     compact: bool = False):
    """Resolve the deployed (params, cfg, masks) triple: ``compact=True``
    materializes the pruning masks via ``compact_params``, so the returned
    network is physically smaller and needs no masks at run time."""
    if compact:
        if not masks:
            raise ValueError(
                "compact=True requires pruning masks: a dense model has "
                "nothing to compact (pass compact=False, or provide the "
                "masks the plan was pruned with)")
        cparams, ccfg = compact_params(params, cfg, masks)
        return cparams, ccfg, None
    return params, cfg, masks


class SplitFnBank:
    """Edge/cloud sub-model callables for every candidate split of one
    deployed network on one device, built on first request and cached
    (batch-1; the batched variants come with the batching slice).

    Construction moves the deployed weights to ``device`` (the CUDA card
    unless the caller names another), converts the conv weights to OIHW
    once, and quantizes the edge's weights once when ``quant`` is set."""

    def __init__(self, params, cfg: CNNConfig, masks=None,
                 compact: bool = False, pack: bool = False,
                 quant: Optional[QuantPolicy] = None,
                 device: DeviceLike = None):
        dparams, self.deploy_cfg, dmasks = deploy_submodels(
            params, cfg, masks, compact)
        self.device = device = resolve_device(device)
        self.pack = pack
        self.compact = compact
        dparams = {k: {n: t.to(device) for n, t in v.items()}
                   for k, v in dparams.items()}
        self._tparams = oihw_params(dparams, self.deploy_cfg)
        self._np_masks = dmasks
        self._masks = masks_to(dmasks, device)
        self.quant = quant
        if quant is not None:
            self._qparams = quantize_params(dparams, self.deploy_cfg, quant)
            self._q_backend = resolve_backend(quant, device)
        self.n_layers = len(self.deploy_cfg.layers)
        self._fns: Dict[int, Tuple] = {}

    def _build(self, split: int) -> Tuple:
        dcfg, masks = self.deploy_cfg, self._masks
        if self.quant is not None:
            qp, qb = self._qparams, self._q_backend

            def edge(x):
                return quant_cnn_apply(qp, dcfg, x, masks=masks,
                                       stop_layer=split, backend=qb)
        else:
            tp = self._tparams

            def edge(x):
                return run_layers(tp, dcfg, x, masks=masks, stop_layer=split)

        def cloud(x):
            return run_layers(self._tparams, dcfg, x, masks=masks,
                              start_layer=split)

        keep = (split_keep_indices(dcfg, self._np_masks, split)
                if self.pack and not self.compact else None)
        return (edge if split > 0 else None,
                cloud if split < self.n_layers else None, keep)

    def get(self, split: int):
        """(edge_fn, cloud_fn, keep) for ``split``; fns are None at the
        c=0 / c=N extremes. ``keep`` is the surviving-channel index set
        for the codec's packing (masked-but-dense deployments only)."""
        if not 0 <= split <= self.n_layers:
            raise ValueError(f"split {split} outside [0, {self.n_layers}]")
        if split not in self._fns:
            self._fns[split] = self._build(split)
        return self._fns[split]


class CollabRunner:
    """In-process split executor with a simulated channel.

    ``compact`` deploys physically-pruned submodels; ``codec``/``pack``
    select the wire encoding of the split-boundary tensor. The reported
    device/server terms come from the analytic Eq. 5 profile when
    ``simulate_compute`` (the default), else from the measured
    wall-clock; the channel term is always charged per transmitted byte.
    (The reference's time-varying link traces, fault injection and
    real-time pacing come with the slices that use them.)
    """

    def __init__(self, params, cfg: CNNConfig, split: int,
                 profile: TwoTierProfile, masks=None,
                 simulate_compute: bool = True,
                 compact: bool = False, codec: str = "fp32",
                 pack: bool = False,
                 quant: Optional[QuantPolicy] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.profile = profile
        self.masks = masks
        self.codec = codec
        self.compact = compact
        self.pack = pack
        self.channel = SimChannel(profile.link)
        self.simulate_compute = simulate_compute
        self._bank = SplitFnBank(params, cfg, masks, compact, pack,
                                 quant=quant, device=device)
        self.deploy_cfg = self._bank.deploy_cfg
        self.device = self._bank.device
        self._edge_fn, self._cloud_fn, self._keep = self._bank.get(split)
        self.split = split
        # the analytic Eq. 5 breakdown at the paper's hardware
        costs = (compacted_cnn_layer_costs(self.cfg, self.masks)
                 if self.compact else cnn_layer_costs(self.cfg, self.masks))
        self._analytic = split_latency(
            costs, split, self.profile, cnn_input_bytes(self.cfg),
            tx_scale=wire_tx_scale(self.cfg, self.masks, split,
                                   codec=self.codec, pack=self.pack,
                                   compact=self.compact))

    def infer(self, image: np.ndarray) -> Dict:
        """image (B, H, W, C) float32. Returns logits (numpy),
        ``RequestTiming`` and the measured ``wallclock`` of each half in
        seconds."""
        dev = self.device
        with torch.inference_mode(), exact_fp32():
            x = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
            synchronize(dev)
            t0 = time.perf_counter()
            if self._edge_fn is not None:
                x = self._edge_fn(x)
                synchronize(dev)
            t1 = time.perf_counter()
            if self._cloud_fn is not None:
                feat = x.cpu().numpy()
                buf = encode_feature(feat, codec=self.codec,
                                     keep=self._keep if feat.ndim > 1
                                     else None)
                tx_bytes = len(buf)
                t_tx = self.channel.send(tx_bytes)
                x = torch.from_numpy(decode_any(buf)[0].copy()).to(dev)
            else:
                tx_bytes, t_tx = 0, 0.0
            synchronize(dev)
            t2 = time.perf_counter()
            out = x
            if self._cloud_fn is not None:
                out = self._cloud_fn(x)
                synchronize(dev)
            t3 = time.perf_counter()
        if self.simulate_compute:
            timing = RequestTiming(self._analytic["T_D"], t_tx,
                                   self._analytic["T_S"], tx_bytes)
        else:
            timing = RequestTiming(t1 - t0, t_tx, t3 - t2, tx_bytes)
        return {"logits": out.cpu().numpy(), "timing": timing,
                "wallclock": {"edge": t1 - t0, "cloud": t3 - t2}}
