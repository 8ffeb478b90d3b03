"""Collaborative split-inference executors (paper §3.3 deployment), the
port of the JAX package's ``repro.core.collab.runtime``.

The public front door is ``repro_torch.serving``: build a
``DeploymentPlan`` and open a session with ``serving.connect(plan,
backend="local"|"socket")``, or serve the cloud half with
``serving.serve(plan)`` / ``serving.CloudServer(plan)``. The executors
below are the layer under it.

``CollabRunner`` — in-process: edge submodel -> (simulated) channel ->
cloud submodel, with the Eq. 5 timing breakdown per request.

``serve_cloud`` / ``EdgeClient`` — real TCP sockets with the token-bucket
shaper, mirroring the paper's socket deployment: the edge sends the
intermediate feature tensor, the cloud returns class logits. The frames
are the reference's, byte for byte (``protocol``), so a port peer and a
JAX peer serve each other.

Every executor resolves its sub-model functions through a ``SplitFnBank``:
one deployed parameter set on one device (the CUDA card unless the caller
names another), an (edge_fn, cloud_fn) pair per candidate split, so a
RESPLIT is a dictionary lookup. The edge half runs the quantized kernel
path (``quant.quant_cnn_apply``, ``masked_matmul`` from int8 codes on the
card) when the plan carries a ``quant`` section, else the fp32 layers; the
cloud half is always fp32 (``models.cnn.run_layers``). Every call runs
inside ``device.exact_fp32()``, since cuDNN would otherwise run the fp32
convolutions in TF32, and under ``torch.inference_mode()``.

The reference jits each half (``jax.jit``); the port runs them eagerly.
Its batched variants map the batch-1 computation over rows, the
counterpart of the reference's ``jax.lax.map``: cuDNN picks its algorithm
per batch shape and ``masked_matmul`` its route per row count, so only
a row-by-row call keeps each row's bits equal to a batch-1 call.

*Cross-client dynamic batching* (``serve_cloud(batching=...)``): handler
threads submit decoded features to the ``DynamicBatcher``
(``batching.py``) — per-lane queues, a short batching window,
power-of-two bucket padding, ONE row-mapped cloud call per fused batch,
logits bit-identical to the unbatched path. All connections of one server
share ONE ``LinkShaper`` token bucket for the bytes the server transmits.

Server threads (a handler per connection, a writer per batching
connection, a scheduler per lane) all launch on the same card, each on
its thread's current stream, the default stream: their launches
serialize there and give the bits one thread would.

``tx_bytes`` is the transmitted frame *payload* in bytes — identical
across CollabRunner and EdgeClient for the same deployment; the socket
executors' 8-byte length prefix is framing, not payload, and is excluded.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from concurrent.futures import CancelledError, Future
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.batching import (BatchingPolicy, DynamicBatcher,
                                              LaneSaturated,
                                              next_pow2_bucket, pad_rows)
from repro_torch.core.collab.channel import (FaultInjector, LinkShaper,
                                             ShapedSocket, SimChannel,
                                             apply_send_fault, recv_exact)
from repro_torch.core.collab.cluster import FleetExhaustedError, FleetRouter
from repro_torch.core.collab.faults import (FaultPolicy, RequestTimeout,
                                            ServerBusy, ServerDraining,
                                            fault_record)
from repro_torch.core.collab.protocol import (CAP_CRC, PROTOCOL_VERSION,
                                              FrameIntegrityError,
                                              PlanMismatchError, decode_any,
                                              decode_busy, decode_drain,
                                              decode_heartbeat, decode_hello,
                                              decode_resplit, decode_sealed,
                                              decode_tensor, encode_busy,
                                              encode_drain, encode_feature,
                                              encode_heartbeat, encode_hello,
                                              encode_resplit, encode_sealed,
                                              encode_tensor, frame_lane,
                                              hello_caps, is_busy, is_drain,
                                              is_heartbeat, is_hello,
                                              is_resplit, is_sealed)
from repro_torch.core.collab.quant import (QuantPolicy, quant_cnn_apply,
                                           quantize_params, resolve_backend)
from repro_torch.core.partition.energy_model import EnergyProfile
from repro_torch.core.partition.latency_model import (
    batched_server_time, cnn_input_bytes, cnn_layer_costs,
    compacted_cnn_layer_costs, split_latency, wire_tx_scale)
from repro_torch.core.partition.profiles import (LinkProfile, LinkTrace,
                                                 TwoTierProfile)
from repro_torch.device import (DeviceLike, exact_fp32, resolve_device,
                                synchronize)
from repro_torch.models.cnn import (compact_params, masks_to, oihw_params,
                                    run_layers, split_keep_indices)


@dataclass
class RequestTiming:
    """Per-request accounting: ``t_*`` in seconds, ``tx_bytes`` the
    transmitted frame payload in bytes, ``e_edge_j`` the edge device's
    energy in joules (None when no ``EnergyProfile`` is attached)."""
    t_device: float
    t_tx: float
    t_server: float
    tx_bytes: int
    e_edge_j: Optional[float] = None


def _frame_io(sock: socket.socket, ch: Optional[ShapedSocket]):
    """(recv_exact, sendall) pair for a connection, shaped or raw."""
    rx = ch.recv_exact if ch else (lambda k: recv_exact(sock, k))
    tx = ch.sendall if ch else sock.sendall
    return rx, tx


def deploy_submodels(params, cfg: CNNConfig, masks=None,
                     compact: bool = False):
    """Resolve the deployed (params, cfg, masks) triple: ``compact=True``
    materializes the pruning masks via ``compact_params``, so the returned
    network is physically smaller and needs no masks at run time. Both
    peers of a split deployment must agree on this flag."""
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
    """Edge/cloud sub-model functions for *every* candidate split of one
    deployed network on one device.

    Construction moves the deployed weights to ``device`` (the CUDA card
    unless the caller names another), converts the conv weights to OIHW
    once, and quantizes the edge's weights once when ``quant`` is set.
    Each split's (edge_fn, cloud_fn, keep) triple is built on first request
    and cached, so a RESPLIT is a dictionary lookup. The functions take
    and return tensors on the bank's device; ``call`` runs one on a numpy
    array and returns numpy.
    """

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
        self._batched_fns: Dict[int, Tuple] = {}
        # serve_cloud handler threads share one bank: first-touch builds
        # of a split's functions must not race the dict insert
        self._cache_lock = threading.Lock()
        #: the port's count of what the reference counts as traces: it
        #: bumps once each time one of this bank's functions first runs at
        #: a new input shape (a new split, a new batch bucket), where cuDNN
        #: and the kernels' routes meet a shape for the first time.
        #: ``warm`` followed by a steady count is the no-new-shape-in-steady-
        #: state regression guard.
        self.n_traces = 0

    def _counted(self, fn: Callable) -> Callable:
        """``fn`` bumping ``n_traces`` at each input shape it first sees."""
        seen = set()

        def run(x: torch.Tensor) -> torch.Tensor:
            shape = tuple(x.shape)
            if shape not in seen:
                seen.add(shape)
                self.n_traces += 1
            return fn(x)
        return run

    def _halves(self, split: int) -> Tuple:
        """The raw (edge, cloud) callables of ``split`` (None at the c=0 /
        c=N extremes) and the packing ``keep``."""
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

    def _build(self, split: int) -> Tuple:
        edge, cloud, keep = self._halves(split)
        return (self._counted(edge) if edge is not None else None,
                self._counted(cloud) if cloud is not None else None, keep)

    def _build_batched(self, split: int) -> Tuple:
        """Row-mapped variants: the batch-1 computation run over the
        leading axis one row at a time in ONE call, each row in new memory
        as a batch-1 call would see it. Per-row results are bit-identical
        to the batch-1 functions — which one batched convolution would
        NOT guarantee (cuDNN picks its algorithm per batch shape,
        ``masked_matmul`` its route per row count) — so the dynamic
        batching engine can promise batched == sequential logits
        exactly."""
        edge, cloud, keep = self._halves(split)

        def by_rows(fn):
            def run(x: torch.Tensor) -> torch.Tensor:
                return torch.cat([fn(x[i:i + 1].clone())
                                  for i in range(x.shape[0])])
            return self._counted(run)
        return (by_rows(edge) if edge is not None else None,
                by_rows(cloud) if cloud is not None else None, keep)

    def get(self, split: int, batch_bucket: Optional[int] = None):
        """(edge_fn, cloud_fn, keep) for ``split``; fns are None at the
        c=0 / c=N extremes. ``keep`` is the surviving-channel index set
        for the wire codec's packing — only set for masked-but-dense
        deployments.

        ``batch_bucket`` selects the row-mapped batched pair meant to be
        called at exactly that (padded) leading-axis size, bit-identical
        per row to the batch-1 pair. ``None`` keeps the batch-1 pair."""
        if not 0 <= split <= self.n_layers:
            raise ValueError(f"split {split} outside [0, {self.n_layers}]")
        if batch_bucket is None:
            with self._cache_lock:
                if split not in self._fns:
                    self._fns[split] = self._build(split)
                return self._fns[split]
        if batch_bucket < 1:
            raise ValueError(f"batch_bucket must be >= 1, got {batch_bucket}")
        with self._cache_lock:
            if split not in self._batched_fns:
                self._batched_fns[split] = self._build_batched(split)
            return self._batched_fns[split]

    def tensor(self, x) -> torch.Tensor:
        """``x`` (numpy, possibly read-only as a decoded frame is) as a
        float32 tensor in new memory on the bank's device."""
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def call(self, fn: Callable, x) -> np.ndarray:
        """Run ``fn`` on ``x`` on the bank's device in exact fp32 and
        return the result as numpy (which waits for the device)."""
        with torch.inference_mode(), exact_fp32():
            return fn(self.tensor(x)).cpu().numpy()

    def warm(self, splits: Sequence[int], image: np.ndarray,
             edge_only: bool = False, buckets: Sequence[int] = (1,),
             cloud_only: bool = False) -> None:
        """Run the edge/cloud pair of each candidate split once on one
        sample, so a mid-run switch meets no cold shape. ``edge_only``
        skips the cloud halves (the edge peer never runs them).

        ``buckets`` additionally runs the row-mapped batched pair at each
        listed leading-axis size > 1. ``cloud_only`` skips the batched
        *edge* halves there (the batching server executes only cloud
        sub-models; its batch-1 edge half still runs once to derive the
        split-boundary feature shape)."""
        for c in splits:
            edge_fn, cloud_fn, _ = self.get(c)
            feat = np.asarray(image)        # split-boundary tensor at c
            if edge_fn is not None:
                feat = self.call(edge_fn, feat)
            if cloud_fn is not None and not edge_only:
                self.call(cloud_fn, feat)
            for b in buckets:
                if b <= 1:
                    continue
                edge_b, cloud_b, _ = self.get(c, batch_bucket=b)
                if edge_b is not None and not cloud_only:
                    self.call(edge_b, np.repeat(np.asarray(image), b, axis=0))
                if cloud_b is not None and not edge_only:
                    self.call(cloud_b, np.repeat(feat, b, axis=0))


def _warm_input(cfg: CNNConfig) -> np.ndarray:
    """A zero batch-1 sample at the model's input shape, for warming."""
    h, w = cfg.input_hw
    return np.zeros((1, h, w, cfg.input_channels), np.float32)


def build_split_fns(params, cfg: CNNConfig, split: int, masks=None,
                    compact: bool = False, pack: bool = False,
                    quant: Optional[QuantPolicy] = None,
                    device: DeviceLike = None):
    """One-stop deployment resolution: (edge_fn, cloud_fn, keep,
    deploy_cfg) for ``split``, a one-shot wrapper over ``SplitFnBank``
    (the reference keeps the same shim importable). The functions take
    and return tensors on the bank's device."""
    bank = SplitFnBank(params, cfg, masks, compact, pack, quant=quant,
                       device=device)
    edge_fn, cloud_fn, keep = bank.get(split)
    return edge_fn, cloud_fn, keep, bank.deploy_cfg


class CollabRunner:
    """In-process split executor with a simulated (or real-time) channel.

    ``compact`` deploys physically-pruned submodels; ``codec``/``pack``
    select the wire encoding of the split-boundary tensor (the payload is
    genuinely encoded and decoded, so lossy codecs see their true
    numerical effect and ``tx_bytes`` is the true frame size). The
    reported device/server terms come from the analytic Eq. 5 profile
    when ``simulate_compute`` (the default), else from the measured
    wall-clock; the channel term is always charged per transmitted byte.
    ``realtime_channel`` sleeps each send's modeled cost away (the port's
    ``SimChannel`` never sleeps itself), ``trace`` replays a time-varying
    link on the channel's virtual clock and ``faults`` charges lost
    copies and stalls against it. ``energy`` (an ``EnergyProfile``)
    prices every request's ``e_edge_j`` from the breakdown its timing
    reports, the RTT peeled off the uplink term and billed as waiting.
    """

    def __init__(self, params, cfg: CNNConfig, split: int,
                 profile: TwoTierProfile, masks=None,
                 realtime_channel: bool = False,
                 simulate_compute: bool = True,
                 compact: bool = False, codec: Optional[str] = None,
                 pack: bool = False, trace: Optional[LinkTrace] = None,
                 faults: Optional[FaultInjector] = None,
                 quant: Optional[QuantPolicy] = None,
                 energy: Optional[EnergyProfile] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.profile = profile
        self.energy = energy
        self.masks = masks
        self.codec = codec
        self.compact = compact
        self.pack = pack
        self.realtime = realtime_channel
        self.channel = SimChannel(profile.link, trace=trace, faults=faults)
        self.simulate_compute = simulate_compute
        self._bank = SplitFnBank(params, cfg, masks, compact, pack,
                                 quant=quant, device=device)
        self.deploy_cfg = self._bank.deploy_cfg
        self.device = self._bank.device
        self.set_split(split)

    def warm(self, splits: Sequence[int]) -> None:
        """Run every candidate's edge/cloud pair once (batch-1 shape)."""
        self._bank.warm(splits, _warm_input(self.cfg))

    def set_split(self, split: int) -> None:
        """Move the partition point: swap in the bank's pair for
        ``split`` and re-price the analytic breakdown. The channel (and
        its virtual trace clock) carries over."""
        self._edge_fn, self._cloud_fn, self._keep = self._bank.get(split)
        self.split = split
        costs = (compacted_cnn_layer_costs(self.cfg, self.masks)
                 if self.compact else cnn_layer_costs(self.cfg, self.masks))
        # tx_scale composes the codec discount with the packing correction
        # so the analytic tx_bytes equals the measured wire payload
        self._analytic = split_latency(
            costs, split, self.profile, cnn_input_bytes(self.cfg),
            tx_scale=wire_tx_scale(self.cfg, self.masks, split,
                                   codec=self.codec, pack=self.pack,
                                   compact=self.compact))

    def _encode(self, x: np.ndarray) -> bytes:
        if self.codec is None and self._keep is None:
            return x.tobytes()          # raw-payload accounting
        return encode_feature(x, codec=self.codec or "fp32",
                              keep=self._keep if x.ndim > 1 else None)

    def _decodes(self) -> bool:
        return self.codec is not None or self._keep is not None

    def _send(self, nbytes: int) -> float:
        """Charge one frame on the channel; real-time pacing sleeps it."""
        t_tx = self.channel.send(nbytes)
        if self.realtime:
            time.sleep(t_tx)
        return t_tx

    def _timing(self, t_device: float, t_tx: float, t_server: float,
                tx_bytes: int) -> RequestTiming:
        """One request's accounting record: the analytic device / server
        terms when ``simulate_compute``, else the measured ones, priced in
        joules when the runner carries an ``EnergyProfile``."""
        if self.simulate_compute:
            t_device, t_server = self._analytic["T_D"], self._analytic["T_S"]
        e = (self.energy.request_energy(t_device, t_tx, t_server,
                                        rtt_s=self.profile.link.rtt_s)
             if self.energy is not None else None)
        return RequestTiming(t_device, t_tx, t_server, tx_bytes, e_edge_j=e)

    def _advance(self, key: str, measured_s: float) -> None:
        """A trace-driven channel keeps degrading during compute, so the
        virtual clock advances across the device and server time too."""
        if self.channel.trace is not None:
            self.channel.advance(self._analytic[key] if self.simulate_compute
                                 else measured_s)

    def infer(self, image: np.ndarray) -> Dict:
        """image (B, H, W, C) float32. Returns logits (numpy),
        ``RequestTiming``, the measured ``wallclock`` of each half in
        seconds and the ``fault`` record of the channel's ARQ."""
        dev = self.device
        with torch.inference_mode(), exact_fp32():
            x = self._bank.tensor(image)
            synchronize(dev)
            t0 = time.perf_counter()
            if self._edge_fn is not None:
                x = self._edge_fn(x)
                synchronize(dev)
            t1 = time.perf_counter()
            self._advance("T_D", t1 - t0)
            if self._cloud_fn is not None:
                feat = x.cpu().numpy()
                buf = self._encode(feat)
                tx_bytes = len(buf)
                t_tx = self._send(tx_bytes)
                if self._decodes():
                    x = self._bank.tensor(decode_any(buf)[0])
            else:
                tx_bytes, t_tx = 0, 0.0
            synchronize(dev)
            t2 = time.perf_counter()
            out = x
            if self._cloud_fn is not None:
                out = self._cloud_fn(x)
                synchronize(dev)
            t3 = time.perf_counter()
            logits = out.cpu().numpy()
        self._advance("T_S", t3 - t2)
        # ARQ accounting from the channel: lost copies were retransmitted
        # by the modeled link layer, so the request was still served
        evs = (self.channel.last_send_events
               if self._cloud_fn is not None else ())
        return {"logits": logits,
                "timing": self._timing(t1 - t0, t_tx, t3 - t2, tx_bytes),
                "wallclock": {"edge": t1 - t0, "cloud": t3 - t2},
                "fault": fault_record(
                    faults=len(evs),
                    retries=sum(1 for e in evs if e != "stall"))}

    def infer_batch(self, images: Sequence[np.ndarray],
                    bucket: Optional[int] = None) -> List[Dict]:
        """Serve a batch of requests through ONE edge call and ONE cloud
        call (the local fast path behind ``infer_many`` on a plan with a
        ``batching`` section). Results are **bit-identical per row** to
        batch-1 execution: compute is the bank's row-mapped batched pair,
        padded to ``bucket`` (next power of two by default). The wire step
        encodes and charges one frame *per request* exactly as the
        sequential loop does."""
        n = len(images)
        if n == 0:
            return []
        arrs = [np.asarray(im) for im in images]
        counts = [a.shape[0] for a in arrs]       # a request may be B rows
        offs = np.concatenate([[0], np.cumsum(counts)])
        rows = int(offs[-1])
        bucket = bucket or next_pow2_bucket(rows)
        if bucket < rows:
            raise ValueError(f"bucket {bucket} smaller than batch of "
                             f"{rows} rows")
        edge_b, cloud_b, _ = self._bank.get(self.split, batch_bucket=bucket)
        xs = pad_rows(np.concatenate(arrs, axis=0), bucket)
        t0 = time.perf_counter()
        feats = self._bank.call(edge_b, xs) if edge_b is not None else xs
        t1 = time.perf_counter()
        self._advance("T_D", t1 - t0)
        per_req: List[Tuple[int, float, Tuple[str, ...]]] = []
        if cloud_b is not None:
            decoded_frames = []
            for i in range(n):           # one frame per request, as infer()
                frame = feats[offs[i]:offs[i] + counts[i]]
                buf = self._encode(frame)
                t_tx = self._send(len(buf))
                per_req.append((len(buf), t_tx,
                                self.channel.last_send_events))
                decoded_frames.append(decode_any(buf)[0] if self._decodes()
                                      else frame)
            decoded = pad_rows(np.concatenate(
                [np.asarray(r) for r in decoded_frames], axis=0), bucket)
            t2 = time.perf_counter()
            out = self._bank.call(cloud_b, decoded)
            t3 = time.perf_counter()
        else:
            per_req = [(0, 0.0, ())] * n
            t2 = t3 = time.perf_counter()
            out = feats
        self._advance("T_S", t3 - t2)
        results = []
        for i in range(n):
            nbytes, t_tx, evs = per_req[i]
            results.append({
                "logits": out[offs[i]:offs[i] + counts[i]],
                "timing": self._timing((t1 - t0) / n, t_tx, (t3 - t2) / n,
                                       nbytes),
                "wallclock": {"edge": t1 - t0, "cloud": t3 - t2},
                "fault": fault_record(
                    faults=len(evs),
                    retries=sum(1 for e in evs if e != "stall"))})
        return results


# ---------------------------------------------------------------------------
# real-socket deployment (localhost stand-in for the paper's Wi-Fi pair)
# ---------------------------------------------------------------------------
def serve_cloud(params, cfg: CNNConfig, split: int, port: int,
                masks=None, link: Optional[LinkProfile] = None,
                max_requests: Optional[int] = None,
                ready: Optional[threading.Event] = None,
                compact: bool = False, host: str = "127.0.0.1",
                max_clients: Optional[int] = 1,
                stop: Optional[threading.Event] = None,
                plan_digest: Optional[str] = None,
                resplit_candidates: Optional[Sequence[int]] = None,
                trace: Optional[LinkTrace] = None,
                batching: Optional[BatchingPolicy] = None,
                batch_stats: Optional[Dict] = None,
                simulate_server=None,
                fault_policy: Optional[FaultPolicy] = None,
                faults: Optional[FaultInjector] = None,
                fault_stats: Optional[Dict] = None,
                die: Optional[threading.Event] = None,
                drain: Optional[threading.Event] = None,
                quant: Optional[QuantPolicy] = None,
                device: DeviceLike = None) -> None:
    """Cloud-side loop: accept edge connections, answer frames, with the
    cloud half on ``device`` (the CUDA card unless the caller names
    another).

    A threaded accept loop serves each connection in its own handler
    thread. ``max_clients`` bounds how many connections are accepted
    before the loop drains and returns (default 1 — the paper's
    single-edge deployment); ``None`` accepts until ``stop`` is set.
    ``max_requests`` is a per-connection limit. All connections draw
    tokens from ONE ``LinkShaper`` for the bytes the server transmits.

    Frames are decoded via ``decode_any``: the edge picks the codec per
    frame through the frame header. ``compact=True`` serves the
    physically-pruned submodel (the connecting edge must match).

    ``plan_digest`` arms the HELLO handshake: a HELLO whose plan digest
    differs from ours is answered with a reject status before the
    connection closes. Edges that skip the HELLO are served unchecked.
    A RESPLIT control frame moves the connection's split point live
    (restricted to ``resplit_candidates`` when given). ``trace`` makes the
    shaper's rate follow a time-varying link.

    ``batching`` arms the cross-client dynamic batching engine: handlers
    submit decoded feature tensors to per-lane queues, a per-connection
    writer thread ships responses back in order while the handler keeps
    reading, and ONE row-mapped cloud call serves each fused batch, with
    logits bit-identical per row to batch-1 execution (a frame wider than
    ``max_batch`` bypasses the engine). ``batch_stats`` (a dict) receives
    the engine's per-lane accounting when the server shuts down.

    ``simulate_server`` (a ``ComputeProfile``) charges every cloud
    invocation the analytic ``batched_server_time`` on that hardware,
    serialized server-wide, after the real compute.

    Fault tolerance: an edge whose HELLO advertises ``CAP_CRC`` gets
    sealed (CRC32 + sequence-number) data frames both ways; a corrupted
    request closes the connection (the edge retries on a fresh one) and
    every data response echoes the request's sequence number.
    ``fault_policy`` arms idle-client reaping (``3 * heartbeat_s``).
    ``stop`` performs a *graceful drain* (queued responses flush), ``die``
    is the crash lever (connections dropped mid-frame), ``drain`` the
    rolling-restart lever (new data requests answered with DRAIN).
    ``faults`` injects the schedule's faults into the data responses;
    ``fault_stats`` (a dict) receives classified error counters
    (``reaped_conns``, ``integrity_errors``, ``conn_errors``,
    ``bad_frames``, ``writer_errors``, ``abandoned_futures``,
    ``heartbeats``, ``busy_shed``, ``drain_redirects``) as they happen.
    A request that would overflow a bounded lane (``max_queue``) is
    answered with a BUSY frame.
    """
    bank = SplitFnBank(params, cfg, masks, compact, quant=quant,
                       device=device)
    charge = None
    if simulate_server is not None:
        sim_costs = (compacted_cnn_layer_costs(cfg, masks)
                     if compact else cnn_layer_costs(cfg, masks))
        device_lock = threading.Lock()

        def charge(c: int, rows: int) -> None:
            dt = batched_server_time(sim_costs, c, simulate_server, rows)
            with device_lock:            # one modeled accelerator
                time.sleep(dt)

    engine = (DynamicBatcher(bank, batching, invoke_cost=charge)
              if batching else None)
    warm_splits = list(resplit_candidates or ())
    if batching and split not in warm_splits:
        warm_splits.append(split)
    if warm_splits:
        # run every (candidate split x batch bucket) pair once so a live
        # RESPLIT or the first concurrent burst meets no cold shape
        bank.warm(warm_splits, _warm_input(cfg),
                  buckets=batching.resolved_buckets if batching else (1,),
                  cloud_only=True)
    shaper = LinkShaper(link, trace=trace) if link or trace else None
    _die = die if die is not None else threading.Event()
    stats_lock = threading.Lock()
    # signalled by every handler on exit so a max_clients-saturated
    # accept loop wakes the instant a slot frees instead of polling
    slot_free = threading.Event()

    def _count(key: str, n: int = 1) -> None:
        if fault_stats is None:
            return
        with stats_lock:
            fault_stats[key] = fault_stats.get(key, 0) + n

    def _handle(conn: socket.socket, rec: Dict) -> None:
        ch = (ShapedSocket(conn, link, trace=trace, shaper=shaper)
              if shaper is not None else None)
        rx, tx = _frame_io(conn, ch)
        cur_split = split
        _, cloud_fn, _ = bank.get(cur_split)
        served = 0
        # idle-client reaping: with a heartbeat interval armed, a client
        # silent for several intervals is presumed dead
        if fault_policy is not None and fault_policy.heartbeat_s > 0:
            conn.settimeout(3.0 * fault_policy.heartbeat_s)

        def _inject(frame: bytes) -> Optional[bytes]:
            """Server-side fault injection on one outgoing data frame."""
            if faults is None:
                return frame
            ev = faults.next_event()
            if ev is None:
                return frame
            if ev.kind == "die":
                # the cloud process is killed: stop accepting, and the
                # accept loop hard-drops every connection mid-frame
                _die.set()
                if stop is not None:
                    stop.set()
                raise ConnectionResetError("injected fault: die")
            return apply_send_fault(ev, frame, conn)

        # -- in-order response pipeline (batching mode): the handler keeps
        # reading and submitting; this writer drains ("ctl", bytes) and
        # ("data", seq, future|bytes) items in arrival order
        resp_q: Optional[queue.Queue] = queue.Queue() if engine else None

        def _writer() -> None:
            try:
                while True:
                    item = resp_q.get()
                    if item is None:
                        return
                    if item[0] == "ctl":
                        tx(struct.pack("<Q", len(item[1])) + item[1])
                        continue
                    _, seq, val = item
                    payload = (encode_tensor(np.asarray(val.result()))
                               if isinstance(val, Future) else val)
                    frame = (encode_sealed(seq, payload)
                             if seq is not None else payload)
                    frame = _inject(frame)
                    if frame is None:
                        continue             # injected drop
                    tx(struct.pack("<Q", len(frame)) + frame)
            except (EOFError, ConnectionError, OSError):
                _count("conn_errors")
                try:
                    conn.shutdown(socket.SHUT_RDWR)      # unblock reader
                except OSError:
                    pass
            except (CancelledError, Exception):          # noqa: BLE001
                # a batch failed (or was cancelled at drain): there is no
                # payload to answer with — drop the connection so the
                # edge retries on a fresh one, and record why
                _count("writer_errors")
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        writer = None
        if engine is not None:
            writer = threading.Thread(target=_writer, daemon=True)
            writer.start()

        def _respond_ctl(payload: bytes) -> None:
            if resp_q is not None:
                resp_q.put(("ctl", payload))
            else:
                tx(struct.pack("<Q", len(payload)) + payload)

        def _respond_data(payload: bytes, seq: Optional[int]) -> None:
            if resp_q is not None:
                resp_q.put(("data", seq, payload))
                return
            frame = (encode_sealed(seq, payload)
                     if seq is not None else payload)
            frame = _inject(frame)
            if frame is not None:
                tx(struct.pack("<Q", len(frame)) + frame)

        try:
            while max_requests is None or served < max_requests:
                (n,) = struct.unpack("<Q", rx(8))
                buf = rx(n)
                if is_heartbeat(buf):
                    decode_heartbeat(buf)   # validates magic + version
                    _count("heartbeats")
                    continue
                seq: Optional[int] = None
                if is_sealed(buf):
                    seq, buf = decode_sealed(buf)   # CRC-checked
                if is_hello(buf):
                    peer, _, pver = decode_hello(buf)
                    peer_caps = hello_caps(buf)
                    ok = (pver == PROTOCOL_VERSION
                          and (plan_digest is None or peer == plan_digest))
                    # sealed frames are armed only when BOTH peers
                    # advertise CAP_CRC
                    _respond_ctl(encode_hello(
                        plan_digest or "", status=0 if ok else 1,
                        caps=CAP_CRC if peer_caps & CAP_CRC else 0))
                    if not ok:
                        return              # contract mismatch: fail fast
                    rec["claimed"] = True   # handshake is not a request
                    continue
                if is_resplit(buf):
                    want, _, pver = decode_resplit(buf)
                    ok = (pver == PROTOCOL_VERSION
                          and 0 <= want <= bank.n_layers
                          and (resplit_candidates is None
                               or want in resplit_candidates))
                    if ok:
                        cur_split = want
                        _, cloud_fn, _ = bank.get(want)
                    _respond_ctl(encode_resplit(want, status=0 if ok else 1))
                    rec["claimed"] = True   # control frame, not a request
                    continue
                if drain is not None and drain.is_set():
                    # rolling restart: answer DRAIN so a fleet-routed edge
                    # migrates and replays elsewhere
                    _count("drain_redirects")
                    _respond_ctl(encode_drain())
                    rec["claimed"] = True
                    continue
                arr, _ = decode_any(buf)
                rows = int(np.asarray(arr).shape[0]) if arr.ndim else 1
                if (engine is not None and cur_split < bank.n_layers
                        and rows <= batching.max_batch):
                    try:
                        fut = engine.submit(cur_split, frame_lane(buf),
                                            np.asarray(arr))
                    except LaneSaturated:
                        # bounded lane overflow: shed with backpressure
                        _count("busy_shed")
                        _respond_ctl(encode_busy("queue"))
                        rec["claimed"] = True
                        continue
                    resp_q.put(("data", seq, fut))
                else:
                    # no engine, c=N passthrough, or a frame wider than
                    # any bucket: the batch-1 fns accept any leading dim
                    logits = (bank.call(cloud_fn, arr) if cloud_fn is not None
                              else np.asarray(arr))  # c=N: edge sent logits
                    if charge is not None and cloud_fn is not None:
                        charge(cur_split, rows)
                    _respond_data(encode_tensor(logits), seq)
                served += 1
                rec["claimed"] = True
        except FrameIntegrityError:
            _count("integrity_errors")      # corrupted request frame
        except socket.timeout:
            _count("reaped_conns")          # idle past the heartbeat window
        except (EOFError, ConnectionError, OSError):
            _count("conn_errors")           # peer went away mid-stream
        except ValueError:
            _count("bad_frames")            # garbage magic / header
        finally:
            if writer is not None:
                resp_q.put(None)
                writer.join(timeout=30)
                # fail anything the dead writer left behind: a pending
                # future is cancelled (its edge will retry), a failed one
                # is observed so it never warns unretrieved
                leaked = 0
                while True:
                    try:
                        item = resp_q.get_nowait()
                    except queue.Empty:
                        break
                    if (item is not None and item[0] == "data"
                            and isinstance(item[2], Future)):
                        fut = item[2]
                        if not fut.done():
                            fut.cancel()
                            leaked += 1
                        elif not fut.cancelled():
                            fut.exception()
                if leaked:
                    _count("abandoned_futures", leaked)
            conn.close()
            slot_free.set()     # wake a max_clients-saturated accept loop

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    srv.settimeout(0.2)
    if ready is not None:
        ready.set()
    # (thread, conn, rec) per in-flight connection. A connection "claims"
    # a max_clients slot only once it completes a handshake or serves a
    # request, so a stray probe cannot drain a bounded server
    pending: List = []
    done_ok = 0
    try:
        while True:
            if (stop is not None and stop.is_set()) or _die.is_set():
                break
            live = []
            for w, c, rec in pending:
                if w.is_alive():
                    live.append((w, c, rec))
                elif rec["claimed"]:
                    done_ok += 1
            pending = live
            if max_clients is not None:
                claimed = done_ok + sum(1 for _, _, rec in pending
                                        if rec["claimed"])
                if claimed >= max_clients:
                    if not pending:
                        break               # budget served and drained
                    slot_free.wait(0.2)
                    slot_free.clear()
                    continue
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            rec = {"claimed": False}
            w = threading.Thread(target=_handle, args=(conn, rec),
                                 daemon=True)
            w.start()
            pending.append((w, conn, rec))
    finally:
        srv.close()
        if _die.is_set():
            # crash semantics: drop every connection mid-frame. Shut down
            # before closing: a close from this thread leaves a handler
            # blocked in recv on the socket (and the peer connected) until
            # the join below gives up on it
            for _, c, _ in pending:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
        elif stop is not None and stop.is_set():
            # graceful drain: stop READING (handlers see EOF and exit
            # their loop) but keep the write side open, so each
            # handler's writer flushes every queued response first
            for _, c, _ in pending:
                try:
                    c.shutdown(socket.SHUT_RD)
                except OSError:
                    pass
        for w, _, _ in pending:
            w.join(timeout=10)
        if engine is not None:
            engine.stop()
            if batch_stats is not None:
                batch_stats.update(engine.stats())


class EdgeClient:
    """Edge side: run layers [0, split) on ``device`` (the CUDA card unless
    the caller names another), ship features, await logits.

    ``host``/``timeout`` make a two-machine deployment expressible;
    ``plan_digest`` arms the HELLO contract handshake against the cloud.

    Two call styles:
      * ``infer(image)`` — synchronous request/response (the paper's loop);
      * ``submit(image)`` / ``collect(count)`` — pipelined: a sender thread
        runs edge compute + transmission while a receiver thread drains
        responses. Results come back in submission order.
    Do not interleave ``infer`` with outstanding ``submit``s.

    ``resplit(split)`` moves the partition point on the live connection
    (RESPLIT control frame + ack).

    Fault tolerance (``fault_policy``): every socket read carries the
    per-request deadline (a dead cloud raises ``RequestTimeout``); with a
    policy armed, ``infer`` survives frame corruption (CRC), timeouts and
    mid-stream disconnects by reconnecting — exponential backoff with
    deterministic jitter, re-HELLO, re-RESPLIT to the current split — and
    replaying the in-flight request under its sequence number. When the
    retry budget or deadline is exhausted, ``fallback="edge"`` serves the
    request locally from the bank's c=N pair. Every ``infer`` result
    carries the ``fault`` record (``{faults, retries, migrations,
    fallback}``); ``faults=`` attaches a client-side ``FaultInjector``
    applied to outgoing data frames.

    Fleet routing (``router``): every (re)connect asks the
    ``FleetRouter`` for the target server, rendezvous-hashed over this
    client's wire *lane* key; transport faults feed its health tracking;
    a DRAIN reply migrates without spending the fault budget, a BUSY
    reply redirects; edge-only fallback engages only when no routable
    member remains (``FleetExhaustedError``). ``sleep_fn`` makes the
    backoff sleeps injectable.
    """

    def __init__(self, params, cfg: CNNConfig, split: int, port: int,
                 masks=None, link: Optional[LinkProfile] = None,
                 compact: bool = False, codec: Optional[str] = None,
                 pack: bool = False, host: str = "127.0.0.1",
                 timeout: float = 30.0,
                 plan_digest: Optional[str] = None,
                 trace: Optional[LinkTrace] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 faults: Optional[FaultInjector] = None,
                 router: Optional[FleetRouter] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 quant: Optional[QuantPolicy] = None,
                 device: DeviceLike = None):
        self._bank = SplitFnBank(params, cfg, masks, compact, pack,
                                 quant=quant, device=device)
        self.device = self._bank.device
        self.edge_fn, _, self._keep = self._bank.get(split)
        self.split = split
        self._plan_split = split      # the split a fresh cloud handler is at
        self.cfg = cfg
        self.codec = codec
        self._host, self._port = host, port
        self._timeout = timeout
        self._link, self._trace = link, trace
        self._digest = plan_digest
        self.policy = fault_policy
        self.faults = faults
        self._router = router
        self._avoid: Tuple[int, ...] = ()
        self._sleep = sleep_fn
        self._rng = fault_policy.make_rng() if fault_policy else None
        self._seq = 0
        self.use_crc = False
        self.last_fault = fault_record()
        self.sock: Optional[socket.socket] = None
        self.ch: Optional[ShapedSocket] = None
        self._send_q: Optional[queue.Queue] = None
        self._out_q: Optional[queue.Queue] = None
        self._outstanding = 0
        self._n_collected = 0
        self._ready: Dict[int, Dict] = {}    # dequeued-but-not-collected
        self._workers: List[threading.Thread] = []
        self._connect()

    # -- connection lifecycle ------------------------------------------------
    def _lane(self) -> str:
        """This client's wire-lane key (the ``protocol.frame_lane``
        vocabulary its data frames will carry)."""
        if self.codec is None and self._keep is None:
            return "raw"
        return ((self.codec or "fp32")
                + ("+packed" if self._keep is not None else ""))

    def _connect(self) -> None:
        """(Re)open the cloud connection: TCP connect, arm the read
        deadline, wrap in the shaper, HELLO (advertising the CRC
        capability), and re-RESPLIT to the current split when it has
        drifted from the plan's. With a fleet router attached the target
        comes from the router."""
        if self._router is not None:
            self._host, self._port = self._router.route(
                self._lane(), exclude=self._avoid)
            self._avoid = ()
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._timeout)
        # one attempt's slice of the per-request deadline is the socket
        # read timeout: a dead cloud surfaces as RequestTimeout
        sock.settimeout(self.policy.attempt_timeout_s()
                        if self.policy is not None else self._timeout)
        self.sock = sock
        self.ch = (ShapedSocket(sock, self._link, trace=self._trace)
                   if self._link or self._trace else None)
        self.use_crc = False
        if self._digest is not None:
            self._handshake(self._digest)
        if self.split != self._plan_split:
            self._resplit_on_wire(self.split)

    def _teardown(self) -> None:
        """Drop the (possibly half-dead) connection; ``_connect`` will
        rebuild it on the next attempt."""
        if self.sock is not None:
            try:
                (self.ch or self.sock).close()
            except OSError:
                pass
        self.sock = None
        self.ch = None
        self.use_crc = False

    def _handshake(self, digest: str) -> None:
        """HELLO exchange: send our plan digest, require the cloud's
        accept, or raise ``PlanMismatchError``. Sealed frames are armed
        iff the cloud echoes ``CAP_CRC``."""
        hello = encode_hello(digest, caps=CAP_CRC)
        self._send(struct.pack("<Q", len(hello)) + hello)
        try:
            rx, _ = _frame_io(self.sock, self.ch)
            (n,) = struct.unpack("<Q", rx(8))
            buf = rx(n)
            peer, status, pver = decode_hello(buf)
        except (EOFError, OSError, ValueError) as e:
            self.sock.close()
            if self.policy is not None and not isinstance(e, ValueError):
                # fault-tolerant edge: a connection torn down during the
                # HELLO is transport trouble — retriable
                raise
            raise PlanMismatchError(
                f"cloud peer closed or answered garbage during the plan "
                f"handshake (legacy server without HELLO support?): {e}")
        if pver != PROTOCOL_VERSION:
            self.sock.close()
            raise PlanMismatchError(
                f"handshake protocol-version mismatch: edge speaks "
                f"v{PROTOCOL_VERSION}, cloud v{pver}")
        if status != 0 or (peer and peer != digest):
            self.sock.close()
            raise PlanMismatchError(
                f"deployment-plan mismatch: edge digest {digest!r}, "
                f"cloud digest {peer or '<unknown>'!r} — both peers must "
                f"load the same DeploymentPlan (split/compact/codec/model)")
        self.use_crc = bool(hello_caps(buf) & CAP_CRC)

    # -- framing ------------------------------------------------------------
    def _encode_payload(self, x: np.ndarray) -> bytes:
        """Frame payload (excluding the 8-byte length prefix)."""
        if self.codec is None and self._keep is None:
            return encode_tensor(x)
        return encode_feature(x, codec=self.codec or "fp32",
                              keep=self._keep)

    def _edge(self, image: np.ndarray) -> np.ndarray:
        """The edge half on the bank's device, as numpy."""
        if self.edge_fn is None:
            return np.asarray(image, np.float32)
        return self._bank.call(self.edge_fn, image)

    def _send(self, frame: bytes) -> None:
        (self.ch.sendall if self.ch else self.sock.sendall)(frame)

    def _send_payload(self, payload: bytes) -> None:
        self._send(struct.pack("<Q", len(payload)) + payload)

    def _send_request(self, seq: int, payload: bytes) -> None:
        """Ship one data frame: sealed (CRC32 + seq) when negotiated,
        with the client-side fault injector applied to the wire bytes."""
        frame = encode_sealed(seq, payload) if self.use_crc else payload
        if self.faults is not None:
            ev = self.faults.next_event()
            if ev is not None:
                maybe = apply_send_fault(ev, frame, self.sock)
                if maybe is None:
                    return              # injected drop: frame never leaves
                frame = maybe
        self._send(struct.pack("<Q", len(frame)) + frame)

    def _recv_response(self, seq: Optional[int] = None) -> np.ndarray:
        """Read one logits response. With ``seq`` set (sealed wire),
        replies are CRC-checked and matched by sequence number (a stale
        reply is discarded). A read past the deadline raises
        ``RequestTimeout``; a DRAIN/BUSY control reply raises the
        matching typed signal."""
        rx, _ = _frame_io(self.sock, self.ch)
        try:
            while True:
                (n,) = struct.unpack("<Q", rx(8))
                buf = rx(n)
                if is_drain(buf):
                    decode_drain(buf)       # validates magic + version
                    raise ServerDraining(
                        f"server {self._host}:{self._port} is draining "
                        f"(rolling restart)")
                if is_busy(buf):
                    reason, redirect, _ = decode_busy(buf)
                    raise ServerBusy(reason=reason, redirect=redirect)
                if is_sealed(buf):
                    rseq, buf = decode_sealed(buf)
                    if seq is not None and rseq != seq:
                        continue        # stale reply from an old attempt
                logits, _ = decode_tensor(buf)
                return logits
        except socket.timeout as e:
            raise RequestTimeout(
                f"no cloud response within the "
                f"{self.sock.gettimeout():.3f}s deadline") from e

    def heartbeat(self) -> None:
        """Send one keepalive frame (no reply expected)."""
        hb = encode_heartbeat()
        self._send(struct.pack("<Q", len(hb)) + hb)

    def warm(self, splits: Sequence[int]) -> None:
        """Run the edge half of every candidate split once (batch-1)."""
        self._bank.warm(splits, _warm_input(self.cfg), edge_only=True)

    # -- live split switch --------------------------------------------------
    def resplit(self, split: int) -> None:
        """Move the split point on the live connection: RESPLIT frame,
        the cloud's ack, then the local edge sub-model swaps. Must not be
        called with outstanding async ``submit``s."""
        if self._outstanding != self._n_collected:
            raise RuntimeError(
                f"resplit with {self._outstanding - self._n_collected} "
                f"outstanding pipelined request(s); collect() them first")
        self._resplit_on_wire(split)
        self.adopt_split(split)

    def _resplit_on_wire(self, split: int) -> None:
        """The raw RESPLIT exchange (frame + ack) on the live connection,
        without touching local sub-model state."""
        self._send_payload(encode_resplit(split))
        rx, _ = _frame_io(self.sock, self.ch)
        (n,) = struct.unpack("<Q", rx(8))
        got, status, _ = decode_resplit(rx(n))
        if status != 0 or got != split:
            raise PlanMismatchError(
                f"cloud rejected resplit to c={split} (not a candidate of "
                f"its deployment plan, or outside the deployed network)")

    def adopt_split(self, split: int) -> None:
        """Swap the local edge sub-model to ``split`` without touching
        the wire; the next reconnect re-RESPLITs to it."""
        self.edge_fn, _, self._keep = self._bank.get(split)
        self.split = split

    # -- synchronous path ---------------------------------------------------
    def _infer_edge_only(self, image: np.ndarray, rec: Dict,
                         t0: float) -> Dict:
        """Degradation-ladder bottom rung: serve the request locally from
        the bank's c=N pair (logits bit-identical to a local c=N run, no
        bytes on the wire)."""
        rec["fallback"] = True
        tf0 = time.perf_counter()
        full_fn, _, _ = self._bank.get(self._bank.n_layers)
        out = self._bank.call(full_fn, image)
        tf1 = time.perf_counter()
        self.last_fault = dict(rec)
        return {"logits": out, "t_edge": tf1 - tf0,
                "t_net_and_cloud": 0.0, "t_tx": 0.0, "tx_bytes": 0,
                "t_total_with_recovery": tf1 - t0,
                "fault": dict(rec)}

    def _exhausted(self, attempt: int, deadline: Optional[float]) -> bool:
        return (self.policy is None
                or attempt >= self.policy.max_retries
                or (deadline is not None and time.monotonic() >= deadline))

    def infer(self, image: np.ndarray) -> Dict:
        """One request/response. ``t_tx`` is the uplink observation: the
        shaper's modeled cost of the feature send when the socket is
        shaped, the send wall-clock on a raw socket. ``t_net_and_cloud``
        additionally includes the cloud compute and the logits downlink.

        With a ``FaultPolicy`` armed this is the recovery loop (backoff,
        reconnect, replay under the same sequence number) until the retry
        budget or the deadline runs out, then the policy's fallback."""
        rec = fault_record()
        t0 = time.perf_counter()
        x = self._edge(image)
        t1 = time.perf_counter()
        payload = self._encode_payload(x)
        self._seq = (self._seq + 1) & 0xFFFFFFFF
        seq = self._seq
        deadline = (time.monotonic() + self.policy.request_deadline_s
                    if self.policy is not None else None)
        attempt = 0
        while True:
            try:
                if self.sock is None:
                    self._connect()     # reconnect: HELLO + re-RESPLIT
                self._send_request(seq, payload)
                t_sent = time.perf_counter()
                logits = self._recv_response(seq if self.use_crc else None)
                if self._router is not None:
                    self._router.note_ok(self._port)
                break
            except PlanMismatchError:
                raise                   # contract breakage is not transient
            except FleetExhaustedError:
                # the whole fleet is dead or draining: edge-only is left
                rec["faults"] += 1
                self.last_fault = dict(rec)
                if (self.policy is not None
                        and self.policy.fallback == "edge"):
                    return self._infer_edge_only(image, rec, t0)
                raise
            except ServerDraining:
                # rolling restart, not a fault: migrate and replay
                rec["migrations"] += 1
                self._teardown()
                if self._router is not None:
                    self._router.note_drain(self._port)
                    self._avoid = (self._port,)
                    continue            # immediate migration, no backoff
                if self._exhausted(attempt, deadline):
                    self.last_fault = dict(rec)
                    if (self.policy is not None
                            and self.policy.fallback == "edge"):
                        return self._infer_edge_only(image, rec, t0)
                    raise
                rec["retries"] += 1
                self._sleep(self.policy.backoff_s(attempt, self._rng))
                attempt += 1
            except ServerBusy as e:
                # overload backpressure: redirect off the saturated lane
                # when the fleet has somewhere else to go, else back off
                rec["migrations"] += 1
                self._teardown()
                redirect = e.redirect and self._router is not None
                if redirect:
                    self._avoid = (self._port,)
                if self._exhausted(attempt, deadline):
                    self.last_fault = dict(rec)
                    if (self.policy is not None
                            and self.policy.fallback == "edge"):
                        return self._infer_edge_only(image, rec, t0)
                    raise
                rec["retries"] += 1
                if not redirect:
                    self._sleep(self.policy.backoff_s(attempt, self._rng))
                attempt += 1
            except (FrameIntegrityError, EOFError, OSError):
                rec["faults"] += 1
                self._teardown()
                if self._router is not None:
                    # feed the health tracker; prefer another member next
                    self._router.note_miss(self._port)
                    self._avoid = (self._port,)
                if self._exhausted(attempt, deadline):
                    self.last_fault = dict(rec)
                    if (self.policy is not None
                            and self.policy.fallback == "edge"):
                        return self._infer_edge_only(image, rec, t0)
                    raise
                rec["retries"] += 1
                pause = self.policy.backoff_s(attempt, self._rng)
                if deadline is not None:
                    pause = min(pause, max(0.0,
                                           deadline - time.monotonic()))
                self._sleep(pause)
                attempt += 1
        t2 = time.perf_counter()
        self.last_fault = dict(rec)
        return {"logits": logits,
                "t_edge": t1 - t0,
                "t_net_and_cloud": t2 - t1,
                "t_tx": (self.ch.last_send_cost_s if self.ch is not None
                         else t_sent - t1),
                "tx_bytes": len(payload),
                "fault": dict(rec)}

    # -- pipelined (async) path ---------------------------------------------
    def _sender_loop(self) -> None:
        while True:
            item = self._send_q.get()
            if item is None:
                # forward the shutdown so the receiver stops only after
                # every request enqueued before close() has been answered
                self._inflight.put(None)
                break
            rid, image = item
            try:
                t0 = time.perf_counter()
                x = self._edge(image)
                t_edge = time.perf_counter() - t0
                payload = self._encode_payload(x)
                self._send_payload(payload)
                self._inflight.put((rid, t_edge, len(payload)))
            except Exception as e:                      # noqa: BLE001
                self._inflight.put((rid, e, 0))

    def _receiver_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                break
            rid, t_edge, nbytes = item
            if isinstance(t_edge, Exception):
                self._out_q.put((rid, t_edge))
                continue
            try:
                logits = self._recv_response()
                self._out_q.put((rid, {"logits": logits, "t_edge": t_edge,
                                       "tx_bytes": nbytes}))
            except Exception as e:                      # noqa: BLE001
                self._out_q.put((rid, e))

    def submit(self, image: np.ndarray) -> int:
        """Enqueue a request; returns its id. Blocks only while the
        64-deep send queue is full."""
        if self._send_q is None:
            self._send_q = queue.Queue(maxsize=64)
            self._inflight = queue.Queue()
            self._out_q = queue.Queue()
            self._workers = [threading.Thread(target=f, daemon=True)
                             for f in (self._sender_loop,
                                       self._receiver_loop)]
            for w in self._workers:
                w.start()
        rid = self._outstanding
        self._outstanding += 1
        self._send_q.put((rid, image))
        return rid

    def collect(self, count: Optional[int] = None,
                timeout: float = 60.0) -> List[Dict]:
        """Block until ``count`` results (default: all outstanding) arrive;
        returns them in submission order. A request that failed raises its
        worker error (after it is consumed)."""
        if count is None:
            count = self._outstanding - self._n_collected
        out: List[Dict] = []
        while len(out) < count:
            rid = self._n_collected          # next id in submission order
            if rid in self._ready:
                res = self._ready.pop(rid)
            else:
                got_rid, res = self._out_q.get(timeout=timeout)
                if got_rid != rid:
                    self._ready[got_rid] = res
                    continue
            self._n_collected += 1
            if isinstance(res, Exception):
                raise res
            out.append(res)
        return out

    def close(self) -> None:
        if self._send_q is not None:
            # the sender forwards this sentinel to the receiver once every
            # already-queued request has been sent (no responses dropped)
            self._send_q.put(None)
            for w in self._workers:
                w.join(timeout=30)
        if self.sock is not None:
            (self.ch or self.sock).close()
