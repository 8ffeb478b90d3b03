"""Cross-client dynamic batching for the cloud peer (a port of the JAX
package's ``repro.core.collab.batching``).

``serve_cloud`` runs one handler thread per connection; without this
module each handler runs its own batch-1 cloud call per frame, so with N
concurrent edges the cloud pays N dispatches per "round" instead of one.
This module amortizes the cloud model invocation across concurrent
clients:

  * connection handlers stop calling ``cloud_fn`` directly and instead
    ``submit`` decoded feature tensors to a ``DynamicBatcher``;
  * requests are queued per **lane** — keyed by ``(split, wire lane,
    compact)`` — so tensors of different shapes or wire encodings are
    never fused and per-lane accounting stays attributable;
  * a scheduler thread per lane drains the queue with a short batching
    window: the first request opens a batch, then up to ``max_wait_ms``
    is spent topping it up to ``max_batch`` rows;
  * the batch is zero-padded to the next **bucket** shape (powers of two
    by default), as the reference pads it to bound its compilations;
    ``SplitFnBank.warm`` over splits x buckets means a live RESPLIT or a
    first burst never meets a cold shape;
  * ONE batched cloud call runs the bucket, and the logits rows are
    scattered back to each request's future. Padded rows are sliced off
    before anything is returned.

The batched call runs the *batch-1 computation row by row*
(``SplitFnBank._build_batched``, the port's counterpart of the
reference's ``jax.lax.map``), never one batched convolution: cuDNN picks
its algorithm per batch shape, and the edge's ``masked_matmul`` its route
per row count, so a batched call would not keep a row's bits. This
engine promises logits **bit-identical** to sequential batch-1 serving.

Knobs travel in ``DeploymentPlan.batching`` (a ``BatchingPolicy``),
digest-folded like the reference's: the bucket/warm set and the in-order
response pipelining are part of the deployment contract both peers arm
for. Plans without a ``batching`` section keep their digests.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two bucket shapes 1, 2, 4, ... capped at ``max_batch``
    (which is always included, power of two or not)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def next_pow2_bucket(n: int) -> int:
    """Smallest power of two >= n — the default padded batch shape
    when no explicit bucket set applies (shared by the engine's clients:
    ``CollabRunner.infer_batch``, the streaming micro-batcher)."""
    if n < 1:
        raise ValueError("bucket for < 1 rows")
    return 1 << (n - 1).bit_length()


def pad_rows(xs: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``xs`` along the leading axis up to ``bucket`` rows (the
    one padding rule every bucketed call site shares — the padded rows
    are computed and discarded, never returned)."""
    n = xs.shape[0]
    if bucket <= n:
        return xs
    return np.concatenate(
        [xs, np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)], axis=0)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that holds ``n`` rows (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} rows exceeds the largest bucket "
                     f"{buckets[-1]}")


class LaneSaturated(RuntimeError):
    """A bounded lane queue is full: admitting this frame would stall
    the connection behind an overloaded server. ``serve_cloud`` answers
    the edge with a BUSY backpressure frame (shed reason ``"queue"``,
    mirroring the fleet simulator's admission semantics) so a
    fleet-routed edge redirects to another member instead of waiting."""


@dataclass(frozen=True)
class BatchingPolicy:
    """Serializable dynamic-batching knobs (the plan's ``batching``
    section).

    ``max_batch`` caps how many feature rows one cloud call fuses;
    ``max_wait_ms`` is the batching window — how long the scheduler holds
    the first request of a batch while topping it up (the latency price
    of throughput; 0 still fuses whatever is already queued);
    ``buckets`` are the padded batch shapes (empty = powers of two
    up to ``max_batch``). ``max_queue`` bounds each lane's queue depth
    in frames: ``None`` (the default, and the historical behaviour)
    queues without bound, a positive bound makes ``submit`` raise
    ``LaneSaturated`` instead of stalling — the overload-backpressure
    contract behind the BUSY wire frame. Serialized only when set, so
    unbounded plans keep their digests.
    """
    max_batch: int = 8
    max_wait_ms: float = 3.0
    buckets: Tuple[int, ...] = ()
    max_queue: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        if self.buckets:
            bs = tuple(int(b) for b in self.buckets)
            if sorted(set(bs)) != list(bs):
                raise ValueError("buckets must be sorted, unique, ascending")
            if bs[0] < 1:
                raise ValueError("buckets must be positive")
            if bs[-1] != self.max_batch:
                raise ValueError(f"largest bucket {bs[-1]} must equal "
                                 f"max_batch {self.max_batch}")
            object.__setattr__(self, "buckets", bs)

    @property
    def resolved_buckets(self) -> Tuple[int, ...]:
        """The effective bucket set (explicit, or powers of two)."""
        return self.buckets or default_buckets(self.max_batch)

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form); the
        lane bound is emitted only when set, so unbounded (historical)
        plans keep their digests byte-for-byte."""
        d = {"max_batch": self.max_batch,
             "max_wait_ms": self.max_wait_ms,
             "buckets": [int(b) for b in self.buckets]}
        if self.max_queue is not None:
            d["max_queue"] = self.max_queue
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "BatchingPolicy":
        mq = d.get("max_queue")
        return cls(max_batch=int(d["max_batch"]),
                   max_wait_ms=float(d["max_wait_ms"]),
                   buckets=tuple(int(b) for b in d.get("buckets", ())),
                   max_queue=int(mq) if mq is not None else None)


@dataclass
class LaneStats:
    """Per-lane accounting: how well the window is filling and how much
    padding the bucket shapes waste. ``batch_sizes`` keeps only the most
    recent cloud calls (bounded — a long-lived server must not leak)."""
    lane: Tuple
    rows: int = 0                 # real feature rows served
    frames: int = 0               # submitted frames (a frame may be B rows)
    batches: int = 0              # cloud calls
    padded_rows: int = 0          # zero rows added to reach the bucket
    busy_s: float = 0.0           # wall time inside the batched cloud call
    failed_rows: int = 0          # rows whose future resolved to an error
    cancelled_frames: int = 0     # frames cancelled at drain/stop
    batch_sizes: "deque" = field(
        default_factory=lambda: deque(maxlen=256))

    @property
    def avg_batch(self) -> float:
        return self.rows / self.batches if self.batches else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of computed rows that were padding."""
        total = self.rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def to_json(self) -> Dict[str, Any]:
        """JSON-ready per-lane record (rows/frames/batches counts,
        ``busy_s`` seconds inside the batched call, padding waste)."""
        return {"lane": list(map(str, self.lane)), "rows": self.rows,
                "frames": self.frames, "batches": self.batches,
                "padded_rows": self.padded_rows, "busy_s": self.busy_s,
                "failed_rows": self.failed_rows,
                "cancelled_frames": self.cancelled_frames,
                "avg_batch": self.avg_batch,
                "padding_waste": self.padding_waste,
                "batch_sizes": list(self.batch_sizes)[-64:]}


class _Lane:
    def __init__(self, key: Tuple):
        self.key = key
        self.q: "queue.Queue" = queue.Queue()
        self.stats = LaneStats(key)
        self.thread: Optional[threading.Thread] = None
        self.carry = None        # popped frame that must open the NEXT batch


class DynamicBatcher:
    """The cross-client dynamic batching engine.

    One instance per cloud server, built over the server's
    ``SplitFnBank`` (one deployed parameter set, sub-model pairs
    per candidate split, batched variants per bucket). Handlers call
    ``submit(split, lane, x)`` and get a ``Future`` resolving to that
    frame's logits rows; a scheduler thread per lane fuses concurrent
    submissions into one padded, bucketed cloud call.

    ``submit`` accepts frames of any row count ``>= 1`` (a pipelined edge
    may ship multi-row frames); ``max_batch`` caps *rows* per cloud call.
    A frame wider than ``max_batch`` is rejected — the client should have
    chunked it.

    ``invoke_cost(split, bucket_rows)`` — optional hook charged once per
    cloud call (after the real compute): ``serve_cloud``'s simulated-
    server mode passes the analytic per-invocation device time here,
    serialized on the modeled accelerator, so colocated benchmarks
    measure the engine against the paper's hardware instead of this
    host's core count. Charged at the padded bucket size — the modeled
    device executes the padding too, which is what makes padding waste a
    physical quantity.
    """

    def __init__(self, bank, policy: BatchingPolicy,
                 invoke_cost: Optional[Any] = None):
        self.bank = bank
        self.policy = policy
        self.invoke_cost = invoke_cost
        self._lanes: Dict[Hashable, _Lane] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    # -- client side --------------------------------------------------------
    def submit(self, split: int, lane: str, x: np.ndarray) -> Future:
        """Queue a decoded feature tensor (rows of one frame) for the
        cloud sub-model at ``split``; returns a Future of its logits.
        With a bounded lane (``policy.max_queue``), raises
        ``LaneSaturated`` instead of queueing when the lane is already
        ``max_queue`` frames deep — the caller sheds with backpressure
        (the BUSY wire frame) rather than stalling the connection."""
        if self._stop.is_set():
            raise RuntimeError("batcher is stopped")
        x = np.asarray(x)
        rows = x.shape[0] if x.ndim > 0 else 1
        if rows > self.policy.max_batch:
            raise ValueError(f"frame has {rows} rows > max_batch "
                             f"{self.policy.max_batch}; chunk it client-side")
        key = (int(split), str(lane), bool(self.bank.compact))
        with self._lock:
            ln = self._lanes.get(key)
            if ln is None:
                ln = _Lane(key)
                ln.thread = threading.Thread(
                    target=self._scheduler, args=(ln,), daemon=True,
                    name=f"batcher-{key}")
                self._lanes[key] = ln
                ln.thread.start()
        if (self.policy.max_queue is not None
                and ln.q.qsize() + (1 if ln.carry is not None else 0)
                >= self.policy.max_queue):
            raise LaneSaturated(
                f"lane {key} is {self.policy.max_queue} frames deep")
        fut: Future = Future()
        ln.q.put((x, rows, fut))
        return fut

    # -- scheduler ----------------------------------------------------------
    def _collect(self, ln: _Lane) -> List[Tuple[np.ndarray, int, Future]]:
        """Block for the first request, then top the batch up (by rows)
        within the ``max_wait_ms`` window."""
        while True:
            if ln.carry is not None:
                first, ln.carry = ln.carry, None
            else:
                try:
                    first = ln.q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop.is_set():
                        return []
                    continue
            if first is None:
                return []
            batch = [first]
            rows = first[1]
            deadline = time.monotonic() + self.policy.max_wait_ms / 1e3
            while rows < self.policy.max_batch:
                left = deadline - time.monotonic()
                try:
                    nxt = (ln.q.get_nowait() if left <= 0
                           else ln.q.get(timeout=left))
                except queue.Empty:
                    break
                if nxt is None:
                    ln.q.put(None)      # re-post for the outer loop
                    break
                if rows + nxt[1] > self.policy.max_batch:
                    # doesn't fit this bucket: hold it — it OPENS the next
                    # batch (re-queueing at the tail would let a steady
                    # stream of small frames starve a wide one forever)
                    ln.carry = nxt
                    break
                batch.append(nxt)
                rows += nxt[1]
            return batch

    def _scheduler(self, ln: _Lane) -> None:
        # a lane thread must never die with futures still queued — a
        # crash anywhere (collect, concatenate, bank build) fails every
        # request waiting on this lane instead of leaving them pending
        try:
            self._scheduler_loop(ln)
        except Exception as e:                           # noqa: BLE001
            self._fail_lane(ln, e)

    def _fail_lane(self, ln: _Lane, exc: Exception) -> None:
        """Resolve everything still queued on a crashed lane with
        ``exc`` — no request may wait forever on a dead scheduler."""
        items = []
        if ln.carry is not None:
            items.append(ln.carry)
            ln.carry = None
        while True:
            try:
                item = ln.q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                items.append(item)
        for _, n, fut in items:
            if not fut.done():
                fut.set_exception(exc)
                ln.stats.failed_rows += n

    def _scheduler_loop(self, ln: _Lane) -> None:
        split = ln.key[0]
        while not self._stop.is_set():
            batch = self._collect(ln)
            if not batch:
                return
            rows = sum(b[1] for b in batch)
            bucket = bucket_for(rows, self.policy.resolved_buckets)
            try:
                xs = pad_rows(np.concatenate([b[0] for b in batch],
                                             axis=0), bucket)
                _, cloud_fn, _ = self.bank.get(split, batch_bucket=bucket)
                t0 = time.perf_counter()
                out = self.bank.call(cloud_fn, xs)
                if self.invoke_cost is not None:
                    self.invoke_cost(split, bucket)
                dt = time.perf_counter() - t0
            except Exception as e:                       # noqa: BLE001
                for _, n, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                        ln.stats.failed_rows += n
                continue
            st = ln.stats
            st.rows += rows
            st.frames += len(batch)
            st.batches += 1
            st.padded_rows += bucket - rows
            st.busy_s += dt
            st.batch_sizes.append(rows)
            off = 0
            for _, n, fut in batch:
                fut.set_result(out[off:off + n])
                off += n

    # -- lifecycle / reporting ----------------------------------------------
    def stop(self, timeout: float = 10.0) -> None:
        """Drain: schedulers finish their current batch, then exit.
        Futures still queued behind the sentinel are cancelled."""
        with self._lock:
            lanes = list(self._lanes.values())
        for ln in lanes:
            ln.q.put(None)
        self._stop.set()
        for ln in lanes:
            if ln.thread is not None:
                ln.thread.join(timeout)
        for ln in lanes:
            if ln.carry is not None:
                if not ln.carry[2].done() and ln.carry[2].cancel():
                    ln.stats.cancelled_frames += 1
                ln.carry = None
            while True:
                try:
                    item = ln.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item[2].done():
                    if item[2].cancel():
                        ln.stats.cancelled_frames += 1

    def pending(self) -> int:
        """Frames still sitting in lane queues (carry slots included) —
        0 after a drain, or the leak count the fault tests assert on."""
        with self._lock:
            lanes = list(self._lanes.values())
        return sum(ln.q.qsize() + (1 if ln.carry is not None else 0)
                   for ln in lanes)

    def stats(self) -> Dict[str, Dict]:
        """Per-lane accounting, JSON-ready, keyed by the lane tuple's
        string form; each record also carries the lane's live ``pending``
        queue depth (0 on a drained engine)."""
        with self._lock:
            out = {}
            for k, ln in self._lanes.items():
                rec = ln.stats.to_json()
                rec["pending"] = ln.q.qsize() + (
                    1 if ln.carry is not None else 0)
                out[str(k)] = rec
            return out
