"""Pipelined streaming collaborative-inference runtime (beyond-paper), the
port of the JAX package's ``core/collab/streaming.py``.

.. note::
   Prefer the ``repro_torch.serving`` front door:
   ``serving.connect(plan, backend="streaming")`` wraps
   ``StreamingCollabRunner`` behind the session interface and takes the
   whole deployment contract from one ``DeploymentPlan``.

The paper's deployment (and ``CollabRunner``) serves requests strictly
sequentially: T_total = sum_i (T_D + T_TX + T_S). When requests stream,
the three stages are independent resources — edge compute, wireless link,
cloud compute — so edge compute of request i+1 can overlap transmission
of request i and cloud compute of request i-1. ``StreamingCollabRunner``
implements that overlap with one worker thread per stage connected by
bounded hand-off queues; steady-state throughput approaches
1 / max(T_D, T_TX, T_S) instead of 1 / (T_D + T_TX + T_S) — the regime
``balanced_split`` optimizes for.

Also supported:
  * micro-batching — while a stage is busy, arrivals queue up, and the
    edge stage drains up to ``microbatch`` of them into one call of the
    bank's row-mapped pair (each row computed as a batch-1 call computes
    it) and one wire frame (amortizing the per-frame header bytes; the
    int8 codec then quantizes the frame with one scale, as the reference
    does);
  * the compacted deployment path and the feature codec, with the same
    semantics as ``CollabRunner`` (frames are genuinely encoded/decoded);
  * per-stage busy-time accounting — ``run`` reports occupancy per stage,
    wire bytes, and end-to-end throughput.

Device work goes through ``SplitFnBank.call`` (inference mode, exact
fp32), so no worker thread runs the fp32 cloud half in TF32. The port's
``SimChannel`` never sleeps: with ``realtime_channel`` the tx stage sleeps
each frame's modeled cost itself, as ``CollabRunner`` does. A stage that
raises stops the pipeline without hanging it, and ``run`` raises the
error.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.channel import SimChannel
from repro_torch.core.collab.protocol import decode_any, encode_feature
from repro_torch.core.collab.quant import QuantPolicy
from repro_torch.core.collab.runtime import SplitFnBank
from repro_torch.core.partition.profiles import LinkTrace, TwoTierProfile
from repro_torch.device import DeviceLike

_DONE = object()


@dataclass
class StageStats:
    name: str
    busy_s: float = 0.0
    items: int = 0
    batches: int = 0

    def charge(self, dt: float, n: int) -> None:
        self.busy_s += dt
        self.items += n
        self.batches += 1


@dataclass
class StreamReport:
    results: List[Dict]
    wall_s: float
    throughput_rps: float
    tx_bytes_total: int
    occupancy: Dict[str, float]          # busy fraction per stage
    stages: Dict[str, StageStats] = field(default_factory=dict)


class StreamingCollabRunner:
    """Three-stage pipelined split executor (edge -> link -> cloud) on one
    device (the card unless the caller names another).

    Same deployment knobs as ``CollabRunner`` (``compact``, ``codec``,
    ``pack``, ``quant``); ``queue_depth`` bounds the hand-off queues
    (backpressure), ``microbatch`` caps how many queued requests the edge
    stage fuses into one call and one frame.
    """

    def __init__(self, params, cfg: CNNConfig, split: int,
                 profile: TwoTierProfile, masks=None,
                 compact: bool = False, codec: Optional[str] = None,
                 pack: bool = False, queue_depth: int = 4,
                 microbatch: int = 1, realtime_channel: bool = True,
                 trace: Optional[LinkTrace] = None,
                 quant: Optional[QuantPolicy] = None,
                 device: DeviceLike = None):
        self.split = split
        self.microbatch = max(1, microbatch)
        self.queue_depth = max(1, queue_depth)
        self.realtime = realtime_channel
        self.channel = SimChannel(profile.link, trace=trace)
        self.codec = codec
        self._bank = SplitFnBank(params, cfg, masks, compact, pack,
                                 quant=quant, device=device)
        self._edge_fn, self._cloud_fn, self._keep = self._bank.get(split)
        self.deploy_cfg = self._bank.deploy_cfg

    def _run_rows(self, fn_single: Callable, x: np.ndarray,
                  role: int) -> np.ndarray:
        """Run ``x`` (B rows) through the batch-1 fn (B == 1) or the
        bank's row-mapped pair (B > 1), which computes each row as the
        batch-1 fn does: per-row results are bit-identical either way.
        The reference pads B to a power of two to bound its jit's shapes;
        the port compiles nothing per shape, so it computes no pad rows."""
        n = int(x.shape[0])
        if n == 1:
            return self._bank.call(fn_single, x)
        fn_b = self._bank.get(self.split, batch_bucket=n)[role]
        return self._bank.call(fn_b, x)

    # -- stages -------------------------------------------------------------
    def _edge_stage(self, in_q: queue.Queue, tx_q: queue.Queue,
                    st: StageStats) -> None:
        while True:
            item = in_q.get()
            if item is _DONE:
                tx_q.put(_DONE)
                return
            ids, imgs = [item[0]], [item[1]]
            while len(ids) < self.microbatch:
                try:
                    nxt = in_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _DONE:
                    in_q.put(_DONE)      # re-post for the outer loop
                    break
                ids.append(nxt[0])
                imgs.append(nxt[1])
            t0 = time.perf_counter()
            x = np.concatenate(imgs, axis=0)
            if self._edge_fn is not None:
                x = self._run_rows(self._edge_fn, x, role=0)
            if self._cloud_fn is not None:
                buf = encode_feature(x, codec=self.codec or "fp32",
                                     keep=self._keep)
            else:
                buf = x                  # edge-only: carry logits through
            st.charge(time.perf_counter() - t0, len(ids))
            tx_q.put((ids, buf))

    def _tx_stage(self, tx_q: queue.Queue, cloud_q: queue.Queue,
                  st: StageStats) -> None:
        while True:
            item = tx_q.get()
            if item is _DONE:
                cloud_q.put(_DONE)
                return
            ids, buf = item
            t0 = time.perf_counter()
            t_model = 0.0
            if self._cloud_fn is not None:
                # the channel's *modeled* cost (bytes/bandwidth + RTT);
                # real-time pacing sleeps it, else the wall-clock here is
                # ~0 and per-request attribution reads this
                t_model = self.channel.send(len(buf))
                if self.realtime:
                    time.sleep(t_model)
            st.charge(time.perf_counter() - t0, len(ids))
            cloud_q.put((ids, buf, t_model))

    def _cloud_stage(self, cloud_q: queue.Queue, results: Dict[int, Dict],
                     st: StageStats) -> None:
        while True:
            item = cloud_q.get()
            if item is _DONE:
                return
            ids, buf, t_model = item
            t0 = time.perf_counter()
            if self._cloud_fn is not None:
                out = self._run_rows(self._cloud_fn, decode_any(buf)[0],
                                     role=1)
                nbytes = len(buf)
            else:
                out, nbytes = buf, 0
            st.charge(time.perf_counter() - t0, len(ids))
            for j, rid in enumerate(ids):
                # frame_n lets downstream consumers amortize per-FRAME
                # constants (the RTT) the same way t_tx_model was split
                results[rid] = {"logits": out[j:j + 1],
                                "tx_bytes": nbytes / len(ids),
                                "t_tx_model": t_model / len(ids),
                                "frame_n": len(ids)}

    @staticmethod
    def _guarded(stage: Callable, in_q: queue.Queue,
                 out_q: Optional[queue.Queue], errors: List[BaseException],
                 *args) -> Callable[[], None]:
        """``stage`` as a thread body that, if it raises, records the
        error, ends the stages after it and drains its own input until
        the end marker, so the stages before it never block on a full
        queue."""
        def run() -> None:
            try:
                stage(in_q, *args)
            except Exception as e:       # noqa: BLE001 — re-raised by run()
                errors.append(e)
                if out_q is not None:
                    out_q.put(_DONE)
                while in_q.get() is not _DONE:
                    pass
        return run

    # -- the stream ---------------------------------------------------------
    def run(self, images: Sequence[np.ndarray]) -> StreamReport:
        """Stream ``images`` (each (1, H, W, C)) through the pipeline.

        Returns per-request results in submission order plus stage
        occupancy and throughput; raises the first stage's error if a
        stage failed.
        """
        in_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        tx_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        cloud_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        results: Dict[int, Dict] = {}
        errors: List[BaseException] = []
        stats = {k: StageStats(k) for k in ("edge", "tx", "cloud")}
        workers = [
            threading.Thread(target=self._guarded(
                self._edge_stage, in_q, tx_q, errors, tx_q, stats["edge"]),
                daemon=True),
            threading.Thread(target=self._guarded(
                self._tx_stage, tx_q, cloud_q, errors, cloud_q, stats["tx"]),
                daemon=True),
            threading.Thread(target=self._guarded(
                self._cloud_stage, cloud_q, None, errors, results,
                stats["cloud"]), daemon=True),
        ]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for i, img in enumerate(images):
            in_q.put((i, np.asarray(img)))
        in_q.put(_DONE)
        for w in workers:
            w.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        n = len(images)
        tx_total = int(sum(r["tx_bytes"] for r in results.values()))
        return StreamReport(
            results=[results[i] for i in range(n)],
            wall_s=wall,
            throughput_rps=n / wall if wall > 0 else float("inf"),
            tx_bytes_total=tx_total,
            occupancy={k: s.busy_s / wall if wall > 0 else 0.0
                       for k, s in stats.items()},
            stages=stats,
        )
