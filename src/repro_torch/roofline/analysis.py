"""Roofline terms on the H100 device model (``repro_torch.roofline.hw``).

    compute term    = FLOPs_per_card / peak_FLOP/s
    memory term     = HBM_bytes_per_card / HBM_bw
    collective term = sum over the collective groups of
                      bytes_per_card(group) / link_rate(group)

``RooflineTerms`` keeps the JAX package's fields, properties and
``as_dict`` keys, priced on this card. The reference reads FLOPs and
bytes from a compiled XLA module's cost analysis and parses collectives
out of its HLO text; the port has no HLO, so it counts the same
quantities while a step is traced (``TraceCounter``, a dispatch mode),
usually under ``FakeTensorMode`` on a fake process group
(``launch.dryrun``):

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, per card;
* bytes accessed: each dispatched op's input and output bytes (views and
  allocations excluded). XLA counts after fusion, this before: it is an
  unfused upper bound, recorded under a key of its own;
* the operand bytes of every collective a card issues, keyed by the
  reference's op names (``COLLECTIVE_OPS``), so the records of the two
  packages compare key for key: the functional collectives DTensor
  redistributes with, the eager ``c10d`` ones (``dist.all_reduce``), and
  point-to-point sends (the pipeline's hop), which are
  ``"collective-permute"``; a receive moves nothing the sender has not
  counted. Collectives issued inside autograd Functions and in the
  backward (the split route's "model" all-reduces, the reduce-scatter a
  per-layer gather's backward makes) dispatch through the mode like any
  other op and count alike. Bytes are also kept by the mesh dim whose
  group carried them, and by op and mesh dim;
* the peak of the live storages the step holds, its inputs included.

**The collective term's rule.** A collective is priced on the links its
group's ranks share, ranks laid out row-major, ``hw.CARDS_PER_NODE`` to a
node: a group inside one node moves a card's bytes at
``hw.NVLINK_BW_PER_DIRECTION``; a group that spans nodes at the card's
share of its node's fabric, ``hw.NODE_FABRIC_BW_PER_CARD`` (a ninth of
NVLink's rate). On the (16, 16) production mesh every group spans nodes:
a 16-wide "model" group is two DGX nodes, a "data" group sixteen, and a
"pod" group joins two meshes; so every collective of the dry run is
priced at the fabric's rate, none at NVLink's. Operand bytes are a
<= 2x-optimistic proxy of a ring's traffic, as in the reference.

``quant_edge_roofline`` and ``check_quant_edge_roofline`` price the
quantized edge's conv and dense layers on any ``ComputeProfile`` (an edge
class of ``core.partition.profiles`` or ``H100_CARD``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.partition.latency_model import (
    quantized_cnn_layer_costs)
from repro_torch.roofline import hw


COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: dispatched collective ops -> the reference's (HLO) op name
_COLLECTIVE_OF = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}
#: ops that move nothing a card counts: allocations, waits, receives, and
#: ``prim.device``, a read of a tensor's device (``torch.as_tensor`` of a
#: tensor makes one)
_NO_BYTES = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.new_empty", "aten.new_empty_strided",
             "_c10d_functional.wait_tensor", "c10d.recv_",
             "c10d.recv_any_source_", "c10d.barrier", "prim.device"}


def shape_bytes(t_or_dtype, shape: Optional[Tuple[int, ...]] = None) -> int:
    """Bytes of a tensor, or of a ``dtype`` and ``shape``."""
    if shape is None:
        t = t_or_dtype
        return t.numel() * t.element_size()
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=t_or_dtype, device="meta").element_size()


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)
    #: the same bytes by the mesh dim (or other group) that carried them
    bytes_by_group: Dict[str, int] = field(default_factory=dict)
    #: bytes/s each group's bytes are priced at (``link_rate``)
    rate_by_group: Dict[str, float] = field(default_factory=dict)
    #: the same bytes by op, then by group
    bytes_by_op_and_group: Dict[str, Dict[str, int]] = field(
        default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def seconds(self) -> float:
        """The collective term: each group's bytes over its link rate."""
        return sum(b / self.rate_by_group[g]
                   for g, b in self.bytes_by_group.items())

    def add(self, op: str, group: str, rate: float, nbytes: int) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        self.bytes_by_group[group] = self.bytes_by_group.get(group, 0) \
            + nbytes
        self.rate_by_group[group] = rate
        by = self.bytes_by_op_and_group.setdefault(op, {})
        by[group] = by.get(group, 0) + nbytes


def link_rate(ranks) -> float:
    """The rate a group of (row-major) ranks moves a card's bytes at:
    NVLink's inside one node, the card's share of the node fabric across
    nodes."""
    nodes = {int(r) // hw.CARDS_PER_NODE for r in ranks}
    return (hw.NVLINK_BW_PER_DIRECTION if len(nodes) <= 1
            else hw.NODE_FABRIC_BW_PER_CARD)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    inner = getattr(t, "_local_tensor", None)
    return t if inner is None else inner


class TraceCounter(TorchDispatchMode):
    """Counts, while a step runs under it, what the roofline terms need:
    per-card FLOPs (``flops``, a nested ``FlopCounterMode``), bytes
    accessed (``bytes_accessed``: each op's inputs and outputs, unfused),
    collective operand bytes (``collectives``, a ``CollectiveStats``), and
    the live storages' peak (``peak_bytes``; ``track`` adds the step's
    inputs, which exist before it runs). Groups are named by ``mesh``'s
    dim names where one carried the collective."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_mode = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._names: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._names[mesh.get_group(i).group_name] = name

    @property
    def flops(self) -> int:
        return self._flop_mode.get_total_flops()

    def __enter__(self):
        self._flop_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._flop_mode.__exit__(*exc)

    # -- live storages ------------------------------------------------------
    def track(self, *trees) -> None:
        """Count the tensors of ``trees`` (a step's inputs) as live."""
        for t in _tensors(trees):
            self._hold(_local(t))

    def _hold(self, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- collectives --------------------------------------------------------
    def _group(self, arg) -> Tuple[str, float]:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        pg = (_resolve_process_group(arg) if isinstance(arg, str)
              else dist.ProcessGroup.unbox(arg))
        ranks = dist.get_process_group_ranks(pg)
        name = self._names.get(pg.group_name)
        if name is None:
            name = ("world" if len(ranks) == dist.get_world_size()
                    else f"group {pg.group_name}")
        return name, link_rate(ranks)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name().split(".")[0].replace("::", ".")
        out = func(*args, **kwargs)
        op = _COLLECTIVE_OF.get(name)
        if op is not None:
            if name.startswith("c10d."):
                # (..., operand, ProcessGroup, ...): the in-place ops'
                # tensors, the others' inputs, come just before the group
                at = next(i for i, a in enumerate(args)
                          if isinstance(a, torch.ScriptObject))
                group, operand = args[at], args[at - 1]
            else:
                group = kwargs.get("group_name", args[-1])
                operand = args[0]
            gname, rate = self._group(group)
            self.collectives.add(op, gname, rate,
                                 sum(shape_bytes(t) for t in
                                     _tensors(operand)))
        elif name not in _NO_BYTES and not func.is_view:
            self.bytes_accessed += sum(
                shape_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(shape_bytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._hold(_local(t))
        return out


@dataclass
class RooflineTerms:
    flops: float                 # PER-CARD flops
    hbm_bytes: float             # PER-CARD bytes accessed
    collective_bytes: float      # per-card collective operand bytes
    chips: int
    #: the collective term, priced group by group (``CollectiveStats.
    #: seconds``); None prices every byte at NVLink's one-way rate
    collective_s: Optional[float] = None

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
        if self.collective_s is not None:
            return self.collective_s
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


def model_flops(cfg, shape_name: str, n_params_active: Optional[int] = None,
                n_params: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE); decode uses
    D = tokens generated this step (=batch)."""
    from repro_torch.launch.specs import SHAPES, mode_of
    S, B = SHAPES[shape_name]
    mode = mode_of(shape_name)
    N = n_params_active if n_params_active is not None else n_params
    D = B * S if mode != "decode" else B
    factor = 6.0 if mode == "train" else 2.0
    return factor * float(N) * float(D)


def terms_from_trace(counter: TraceCounter,
                     chips: int) -> Tuple[RooflineTerms, CollectiveStats]:
    """The roofline terms of a step traced under ``counter``, and its
    collectives (the port's counterpart of ``terms_from_compiled``)."""
    coll = counter.collectives
    return RooflineTerms(float(counter.flops), float(counter.bytes_accessed),
                         float(coll.total_bytes), chips,
                         collective_s=coll.seconds), coll


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
