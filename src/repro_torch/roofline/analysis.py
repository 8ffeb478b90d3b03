"""Roofline terms on the H100 device model (``repro_torch.roofline.hw``).

    compute term    = FLOPs_per_card / peak_FLOP/s
    memory term     = HBM_bytes_per_card / HBM_bw
    collective term = collective_bytes_per_card / NVLink_bw (one direction)

``RooflineTerms`` keeps the JAX package's fields, properties and
``as_dict`` keys, priced on this card. Its inputs come, in the reference,
from a compiled XLA module (``terms_from_compiled`` reads the cost
analysis and the collectives of its HLO text); the port's counterparts,
FLOPs and bytes of a traced step and collectives from
``torch.distributed``, belong to the distributed dry-run that is still
to be ported, so here the terms are built from numbers the caller has.

``quant_edge_roofline`` and ``check_quant_edge_roofline`` price the
quantized edge's conv and dense layers on any ``ComputeProfile`` (an edge
class of ``core.partition.profiles`` or ``H100_CARD``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.partition.latency_model import (
    quantized_cnn_layer_costs)
from repro_torch.roofline import hw


@dataclass
class RooflineTerms:
    flops: float                 # PER-CARD flops
    hbm_bytes: float             # PER-CARD bytes accessed
    collective_bytes: float      # per-card collective operand bytes
    chips: int

    @property
    def flops_global(self) -> float:
        return self.flops * self.chips

    @property
    def hbm_bytes_global(self) -> float:
        return self.hbm_bytes * self.chips

    @property
    def t_compute(self) -> float:
        # global/(chips*peak) == per-card/peak
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / hw.NVLINK_BW_PER_DIRECTION

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "flops_global": self.flops_global,
            "hbm_bytes_global": self.hbm_bytes_global,
            "collective_bytes_per_chip": self.collective_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
        }


# ---------------------------------------------------------------------------
# quantized edge-kernel roofline (the MCU/Pi memory-bound ceiling)
# ---------------------------------------------------------------------------
def quant_edge_roofline(cfg, masks, profile,
                        weight_bits: Optional[int] = 8) -> list:
    """Per-layer roofline of the quantized kernel edge path on a
    ``ComputeProfile``: compute at the profile's int8 MAC throughput
    (fp32 throughput when ``weight_bits=None``), memory as weight
    streaming at the quantized width *plus* the activation traffic the
    split model already prices (``2 * out_bytes``). The batch-1 GEMMs
    (``fc*``) stream O(model) weights for 2 FLOPs a weight, so int8
    pushes them through the ridge point into the memory-bound regime,
    which is what ``check_quant_edge_roofline`` pins for the MCU/Pi
    profiles.

    Returns one dict per conv/dense layer: ``{index, name,
    t_compute_s, t_memory_s, memory_bound, memory_share}`` with
    ``memory_share = t_memory / (t_compute + t_memory)``."""
    ops_per_s = (profile.flops_per_s if weight_bits is None
                 else profile.int8_ops_per_s)
    rows = []
    for c in quantized_cnn_layer_costs(cfg, masks, weight_bits):
        if not (c.name.startswith("conv") or c.name.startswith("fc")):
            continue
        t_c = c.flops / ops_per_s
        t_m = (c.params_bytes + 2 * c.out_bytes) / profile.mem_bw
        rows.append({"index": c.index, "name": c.name,
                     "t_compute_s": t_c, "t_memory_s": t_m,
                     "memory_bound": t_m >= t_c,
                     "memory_share": t_m / (t_c + t_m) if t_c + t_m else 1.0})
    return rows


def check_quant_edge_roofline(cfg, masks, profile,
                              weight_bits: Optional[int] = 8,
                              min_memory_share: float = 0.5) -> list:
    """Check that the quantized GEMM (``fc``) layers reach the
    memory-bound ceiling on ``profile``: each must be memory-bound
    (``t_memory >= t_compute``) with a memory share of at least
    ``min_memory_share``. Raises ``AssertionError`` naming the offending
    layer, as the reference does (raised, so ``python -O`` keeps the
    check); returns the full ``quant_edge_roofline`` report."""
    rows = quant_edge_roofline(cfg, masks, profile, weight_bits)
    for r in rows:
        if not r["name"].startswith("fc"):
            continue
        if not r["memory_bound"]:
            raise AssertionError(
                f"{r['name']} on {profile.name}: compute-bound "
                f"(t_compute={r['t_compute_s']:.3e}s > "
                f"t_memory={r['t_memory_s']:.3e}s) at weight_bits="
                f"{weight_bits} — the quantized kernel does not reach the "
                f"memory-bound ceiling")
        if r["memory_share"] < min_memory_share:
            raise AssertionError(
                f"{r['name']} on {profile.name}: memory share "
                f"{r['memory_share']:.2f} < {min_memory_share} at "
                f"weight_bits={weight_bits}")
    return rows
