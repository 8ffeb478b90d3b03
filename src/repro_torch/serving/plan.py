"""``DeploymentPlan`` — the serializable deployment contract (paper §3.3),
byte-compatible with the JAX package's ``repro/serving/plan.py``.

A plan is one logical object: a (possibly pruned) model, a split point, and
a wire encoding shared by an edge and a cloud peer. ``contract()`` and
``digest`` hash exactly what the reference hashes, ``save``/``load`` write
and read the reference's directory layout (``plan.json``,
``params.npz``/``params.json``, ``masks.npz``), so a plan made by either
package loads in the other with the same digest.

The ``quant``, ``adaptive``, ``batching``, ``energy``, ``faults``,
``fleet`` and ``routing`` sections are the policy objects of the
reference (``QuantPolicy``, ``AdaptivePolicy``, ``BatchingPolicy``,
``EnergyPolicy``, ``FaultPolicy``, ``FleetScenario``, ``RoutingPolicy``;
a section given as its JSON dict is read with the policy's
``from_json``). An ``adaptive`` section's candidates are normalized as
the reference normalizes them (sorted, unique, always holding the
initial split); with an ``energy`` section ``from_args(split=None)``
picks the split by the policy's weighted latency·energy objective. The
``fleet`` section is descriptive: it pins the simulated deployment a plan
is studied for (``core.fleet``, run by ``simulate_fleet``) and configures
neither peer, so a fleet plan serves exactly as the same plan without
it. Each optional section folds into the digest only when set, as in the
reference.

``DeploymentPlan.from_pipeline(result)`` packages what
``core.pipeline.run_paper_pipeline`` produced (fine-tuned params, masks,
the re-priced deploy split, codec, hardware profile).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.base import CNNConfig, ConvLayerSpec
from repro_torch.core.collab.adaptive import AdaptivePolicy
from repro_torch.core.collab.batching import BatchingPolicy
from repro_torch.core.collab.cluster import RoutingPolicy
from repro_torch.core.collab.faults import FaultPolicy
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.collab.quant import QuantPolicy
from repro_torch.core.fleet.scenario import FleetScenario
from repro_torch.core.partition.energy_model import EnergyPolicy
from repro_torch.core.partition.latency_model import (
    cnn_input_bytes, cnn_layer_costs, compacted_cnn_layer_costs,
    wire_tx_scale)
from repro_torch.core.partition.profiles import (ComputeProfile, LinkProfile,
                                                 PAPER_PROFILE,
                                                 TwoTierProfile)
from repro_torch.core.partition.splitter import (energy_aware_split,
                                                 greedy_split)

PLAN_VERSION = 1
#: sections held as policy objects, by the policy class
POLICY_SECTIONS = {"adaptive": AdaptivePolicy, "batching": BatchingPolicy,
                   "energy": EnergyPolicy, "faults": FaultPolicy,
                   "fleet": FleetScenario, "routing": RoutingPolicy}


def _cfg_to_json(cfg: CNNConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["layers"] = [dataclasses.asdict(s) for s in cfg.layers]
    return d


def _cfg_from_json(d: Dict[str, Any]) -> CNNConfig:
    layers = tuple(ConvLayerSpec(**s) for s in d["layers"])
    return CNNConfig(**{**d, "layers": layers,
                        "input_hw": tuple(d["input_hw"])})


def _profile_to_json(p: TwoTierProfile) -> Dict[str, Any]:
    return {"device": dataclasses.asdict(p.device),
            "server": dataclasses.asdict(p.server),
            "link": dataclasses.asdict(p.link)}


def _profile_from_json(d: Dict[str, Any]) -> TwoTierProfile:
    return TwoTierProfile(ComputeProfile(**d["device"]),
                          ComputeProfile(**d["server"]),
                          LinkProfile(**d["link"]))


def _mask_array(m) -> np.ndarray:
    return (m.detach().cpu().numpy() if torch.is_tensor(m)
            else np.asarray(m))


@dataclass
class DeploymentPlan:
    """One deployment contract: model + split + wire encoding + link.

    ``cfg``/``params``/``masks`` are the *logical* (pre-compaction)
    network, params as the port's dict of tensors in the reference layout;
    ``compact=True`` materializes the masks at deploy time.
    ``codec``/``pack`` pick the wire encoding of the split-boundary
    tensor; ``profile`` is the two-tier hardware model for the analytic
    Eq. 5 timing; ``host``/``port``/``connect_timeout_s``/``shape_link``
    are the transport section the socket backend connects and listens by.
    """
    cfg: CNNConfig
    params: Dict
    split: int
    masks: Optional[Dict[int, np.ndarray]] = None
    compact: bool = False
    codec: str = "fp32"
    pack: bool = False
    profile: TwoTierProfile = PAPER_PROFILE
    host: str = "127.0.0.1"
    port: int = 29500
    connect_timeout_s: float = 30.0
    shape_link: bool = True
    adaptive: Optional[AdaptivePolicy] = None
    batching: Optional[BatchingPolicy] = None
    energy: Optional[EnergyPolicy] = None
    faults: Optional[FaultPolicy] = None
    fleet: Optional[FleetScenario] = None
    routing: Optional[RoutingPolicy] = None
    quant: Optional[QuantPolicy] = None
    version: int = PLAN_VERSION

    def __post_init__(self) -> None:
        n = len(self.cfg.layers)
        if not 0 <= self.split <= n:
            raise ValueError(f"split {self.split} outside [0, {n}]")
        if self.codec not in CODEC_TX_SCALE:
            raise ValueError(f"unknown codec {self.codec!r} "
                             f"(use {list(CODEC_TX_SCALE)})")
        if self.compact and not self.masks:
            raise ValueError("compact=True requires pruning masks "
                             "(a dense model has nothing to compact)")
        if self.masks is not None:
            self.masks = {int(i): _mask_array(m) for i, m in
                          sorted(self.masks.items())}
        for name, policy in POLICY_SECTIONS.items():
            sec = getattr(self, name)
            if isinstance(sec, dict):
                setattr(self, name, policy.from_json(sec))
        if self.adaptive is not None:
            # sorted, unique, always containing the initial split (so the
            # controller's current point stays sweepable)
            cands = sorted({int(c) for c in self.adaptive.candidates}
                           | {self.split})
            bad = [c for c in cands if not 0 <= c <= n]
            if bad:
                raise ValueError(f"adaptive candidates {bad} outside "
                                 f"[0, {n}]")
            self.adaptive = dataclasses.replace(self.adaptive,
                                                candidates=tuple(cands))

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_args(cls, params, cfg: CNNConfig, split: Optional[int] = None,
                  *, masks=None, compact: bool = False, codec: str = "fp32",
                  pack: bool = False,
                  profile: TwoTierProfile = PAPER_PROFILE,
                  **transport) -> "DeploymentPlan":
        """Build a plan from explicit pieces. ``split=None`` runs the
        greedy split sweep (Algorithm 1) on the deployed shapes —
        compacted when ``compact``, masked otherwise — with the wire cost
        of each candidate priced in (``wire_tx_scale``); with an
        ``energy`` section it minimizes that policy's weighted
        latency·energy objective instead (the same split at energy
        weight 0)."""
        if split is None:
            deploy_compact = compact and bool(masks)
            np_masks = ({int(i): _mask_array(m) for i, m in masks.items()}
                        if masks else masks)
            costs = (compacted_cnn_layer_costs(cfg, np_masks)
                     if deploy_compact else cnn_layer_costs(cfg, np_masks))
            scale = lambda c: wire_tx_scale(    # noqa: E731
                cfg, np_masks, c, codec=codec, pack=pack,
                compact=deploy_compact)
            energy = transport.get("energy")
            if isinstance(energy, dict):
                energy = EnergyPolicy.from_json(energy)
            if energy is not None:
                split = energy_aware_split(
                    costs, profile, cnn_input_bytes(cfg), energy,
                    tx_scale=scale).split_point
            else:
                split = greedy_split(costs, profile, cnn_input_bytes(cfg),
                                     tx_scale=scale).split_point
        return cls(cfg=cfg, params=params, split=int(split), masks=masks,
                   compact=compact, codec=codec, pack=pack, profile=profile,
                   **transport)

    @classmethod
    def from_pipeline(cls, result, *, compact: bool = True,
                      codec: Optional[str] = None,
                      **transport) -> "DeploymentPlan":
        """Package a ``PaperPipelineResult``: fine-tuned params + masks,
        the stage-6 re-priced deploy split (falling back to the stage-5
        split for a non-compact deployment), and the pipeline's profile."""
        compact = compact and bool(result.masks)
        dec = (result.deploy_split
               if compact and result.deploy_split is not None
               else result.split)
        return cls.from_args(
            result.params, result.cfg, dec.split_point, masks=result.masks,
            compact=compact, codec=codec or result.deploy_codec,
            pack=not compact and bool(result.masks),
            profile=result.profile, **transport)

    # -- contract digest ----------------------------------------------------
    def contract(self) -> Dict[str, Any]:
        """What both peers must agree on for frames to decode correctly;
        each optional section is present only when set, so plans without
        it keep their digests (the reference's rule)."""
        masks = None
        if self.masks:
            masks = {str(i): np.nonzero(np.asarray(m) > 0)[0].tolist()
                     for i, m in self.masks.items()}
        doc = {"version": self.version, "cfg": _cfg_to_json(self.cfg),
               "split": self.split, "masks": masks,
               "compact": self.compact, "codec": self.codec,
               "pack": self.pack}
        if self.adaptive is not None:
            doc["adaptive"] = self.adaptive.to_json()
        if self.batching is not None:
            doc["batching"] = self.batching.to_json()
        if self.energy is not None:
            doc["energy"] = self.energy.to_json()
        if self.faults is not None:
            doc["faults"] = self.faults.to_json()
        if self.fleet is not None:
            doc["fleet"] = self.fleet.to_json()
        if self.routing is not None:
            doc["routing"] = self.routing.to_json()
        if self.quant is not None:
            doc["quant"] = self.quant.to_json()
        return doc

    @property
    def digest(self) -> str:
        blob = json.dumps(self.contract(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the plan into directory ``path`` (created if missing) in
        the reference's layout. Returns ``path``."""
        os.makedirs(path, exist_ok=True)
        interop.save_params(os.path.join(path, "params"), self.params,
                            metadata={"digest": self.digest})
        if self.masks:
            np.savez(os.path.join(path, "masks.npz"),
                     **{str(i): np.asarray(m)
                        for i, m in self.masks.items()})
        doc = {"version": self.version, "digest": self.digest,
               "cfg": _cfg_to_json(self.cfg), "split": self.split,
               "compact": self.compact, "codec": self.codec,
               "pack": self.pack, "profile": _profile_to_json(self.profile),
               "link": {"host": self.host, "port": self.port,
                        "connect_timeout_s": self.connect_timeout_s,
                        "shape_link": self.shape_link},
               "quant": self.quant.to_json() if self.quant else None,
               "has_masks": bool(self.masks)}
        for name in POLICY_SECTIONS:
            sec = getattr(self, name)
            doc[name] = sec.to_json() if sec else None
        with open(os.path.join(path, "plan.json"), "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "DeploymentPlan":
        """Reconstruct a saved plan; verifies the stored digest still
        matches the reconstructed contract."""
        with open(os.path.join(path, "plan.json")) as f:
            doc = json.load(f)
        cfg = _cfg_from_json(doc["cfg"])
        params = interop.restore_params(os.path.join(path, "params"), cfg)
        masks = None
        if doc.get("has_masks"):
            with np.load(os.path.join(path, "masks.npz")) as data:
                masks = {int(k): data[k] for k in data.files}
        link = doc["link"]
        sections = {name: doc.get(name) or None
                    for name in POLICY_SECTIONS}
        quant = (QuantPolicy.from_json(doc["quant"])
                 if doc.get("quant") else None)
        plan = cls(cfg=cfg, params=params, split=doc["split"], masks=masks,
                   compact=doc["compact"], codec=doc["codec"],
                   pack=doc["pack"],
                   profile=_profile_from_json(doc["profile"]),
                   host=link["host"], port=link["port"],
                   connect_timeout_s=link["connect_timeout_s"],
                   shape_link=link["shape_link"], quant=quant,
                   version=doc["version"], **sections)
        if plan.digest != doc["digest"]:
            raise ValueError(
                f"plan digest mismatch after load: stored {doc['digest']}, "
                f"reconstructed {plan.digest} — the artifact was edited or "
                f"written by an incompatible plan version")
        return plan

    # -- convenience --------------------------------------------------------
    def describe(self) -> str:
        """One-line human summary of the deployment contract (digest,
        split, pruning, wire encoding, link endpoint, armed sections), the
        reference's string for the same plan."""
        n = len(self.cfg.layers)
        prune = (f"{len(self.masks)} masked layers" if self.masks
                 else "dense")
        adapt = (f", adaptive over {list(self.adaptive.candidates)}"
                 if self.adaptive else "")
        batch = (f", batched<= {self.batching.max_batch}"
                 f"@{self.batching.max_wait_ms}ms"
                 if self.batching else "")
        joule = ""
        if self.energy is not None:
            joule = (f", energy={self.energy.profile.name}"
                     f"@{self.energy.energy_weight_s_per_j:g}s/J")
            if self.energy.battery_j is not None:
                joule += f" battery={self.energy.battery_j:g}J"
        tol = (f", faults: retries<={self.faults.max_retries}"
               f" fallback={self.faults.fallback}"
               if self.faults else "")
        flt = (f", fleet={self.fleet.name}"
               f"({self.fleet.n_edges}x{self.fleet.n_cloudlets})"
               if self.fleet else "")
        rte = (f", routed over {len(self.routing.ports)} servers"
               if self.routing else "")
        qnt = (f", quant={self.quant.describe()}" if self.quant else "")
        return (f"DeploymentPlan[{self.digest}] {self.cfg.name}: "
                f"split c={self.split}/{n}, {prune}, "
                f"compact={self.compact}, codec={self.codec}"
                f"{'+packed' if self.pack and not self.compact else ''}, "
                f"link={self.host}:{self.port} "
                f"({self.profile.link.name})"
                f"{adapt}{batch}{joule}{tol}{flt}{rte}{qnt}")
