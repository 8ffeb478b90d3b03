"""``InferenceSession`` — one session interface over the deployment
backends the port serves, all constructed from the same ``DeploymentPlan``
(the port of the JAX package's ``repro.serving.session``):

  * ``connect(plan, backend="local")`` — in-process split executor
    (``CollabRunner``): real compute, byte-accurate simulated channel,
    analytic Eq. 5 timing.
  * ``connect(plan, backend="socket")`` — a real TCP edge client
    (``EdgeClient``) against a cloud peer started with ``serve(plan)`` /
    ``CloudServer(plan)``, of this package or of the JAX package: the
    frames and the HELLO handshake are the reference's, so both peers
    must present the same plan digest or the session fails fast with
    ``PlanMismatchError``.

Every entry point (``connect``, ``serve``, ``CloudServer``,
``CloudFleet``) runs on the CUDA card unless the caller passes
``device="cpu"``, and raises without a card. The ``streaming`` backend and
plans with an ``adaptive``, ``energy`` or ``fleet`` section come with the
next slice of the port: ``connect`` and ``serve`` raise
``NotImplementedError`` for them.

Every backend returns the same result shape from ``infer`` /
``infer_many``::

    {"logits": np.ndarray, "t_edge": float|None, "t_upstream": float|None,
     "t_total": float|None, "tx_bytes": int|None, "e_edge_j": None,
     "fault": {"faults": int, "retries": int, "migrations": int,
               "fallback": bool}}

``t_*`` are seconds, ``tx_bytes`` is the transmitted frame payload in
bytes (identical across backends for the same plan), ``e_edge_j`` stays
None (no energy section is served yet) and ``fault`` is the uniform
per-request fault accounting. The local backend adds the measured
``wallclock`` seconds of its edge and cloud halves.

**Fault-tolerant plans** (``plan.faults`` set): the socket session's
``EdgeClient`` retries transient failures (reconnect + re-HELLO +
re-RESPLIT + replay by sequence number) under the policy's backoff and
deadline, and falls back to edge-only inference when the budget
exhausts. **Batched plans** (``plan.batching`` set): the cloud peer
fuses concurrent requests through the ``DynamicBatcher``, and the local
session's ``infer_many`` runs a batch through one edge and one cloud
call, logits bit-identical to the sequential loop. **Fleet-routed plans**
(``plan.routing`` set): the socket session routes by its wire-lane key
over the plan's member ports, and ``CloudFleet`` starts one
``CloudServer`` per member with the chaos controls ``kill``, ``drain``
and ``restart``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.collab.batching import bucket_for
from repro_torch.core.collab.channel import FaultInjector
from repro_torch.core.collab.cluster import FleetRouter
from repro_torch.core.collab.faults import fault_record
from repro_torch.core.collab.protocol import PlanMismatchError  # noqa: F401
from repro_torch.core.collab.runtime import (CollabRunner, EdgeClient,
                                             serve_cloud)
from repro_torch.core.partition.profiles import LinkTrace
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.plan import DeploymentPlan

BACKENDS = ("local", "socket", "streaming")
#: what the next slice of the port brings
NEXT_SLICE = ("the streaming backend and the adaptive controller come with "
              "the next slice of the port")


def _refuse_unported(plan: DeploymentPlan) -> None:
    unported = plan.unported_sections()
    if unported:
        raise NotImplementedError(
            f"the plan carries section(s) {unported} that the PyTorch port "
            f"does not serve yet: {NEXT_SLICE}")


def _result(logits, t_edge: Optional[float], t_upstream: Optional[float],
            tx_bytes: Optional[int], fault: Optional[Dict] = None,
            wallclock: Optional[Dict[str, float]] = None) -> Dict:
    """The one result shape every backend returns (``wallclock`` only
    where the backend measures each half)."""
    total = (None if t_edge is None or t_upstream is None
             else t_edge + t_upstream)
    out = {"logits": np.asarray(logits), "t_edge": t_edge,
           "t_upstream": t_upstream, "t_total": total,
           "tx_bytes": tx_bytes, "e_edge_j": None,
           "fault": dict(fault) if fault else fault_record()}
    if wallclock is not None:
        out["wallclock"] = wallclock
    return out


class InferenceSession:
    """Base session: one deployed plan, uniform request interface.
    ``split`` is the current partition point."""

    backend: str = "?"

    def __init__(self, plan: DeploymentPlan):
        _refuse_unported(plan)
        self.plan = plan
        self.split: int = plan.split

    def infer(self, image: np.ndarray) -> Dict:
        """Serve one request (image ``(B, H, W, C)`` float32)."""
        raise NotImplementedError

    def infer_many(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """Serve requests one after another."""
        return [self.infer(img) for img in images]

    def close(self) -> None:
        """Release the backend's resources (sockets, worker threads)."""

    def __enter__(self) -> "InferenceSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LocalSession(InferenceSession):
    """In-process split executor on one device. ``t_edge``/``t_upstream``
    come from the analytic hardware profile when ``simulate_compute`` (the
    default), else from the measured wall-clock of each half; the channel
    term is always charged per transmitted byte. A ``trace`` replays a
    time-varying link on the simulated channel, ``faults`` its ARQ."""

    backend = "local"

    def __init__(self, plan: DeploymentPlan, *, device: DeviceLike = None,
                 realtime_channel: bool = False,
                 simulate_compute: bool = True,
                 trace: Optional[LinkTrace] = None,
                 faults: Optional[FaultInjector] = None):
        super().__init__(plan)
        self.device = resolve_device(device)
        self._runner = CollabRunner(
            plan.params, plan.cfg, plan.split, plan.profile,
            masks=plan.masks, realtime_channel=realtime_channel,
            simulate_compute=simulate_compute, compact=plan.compact,
            codec=plan.codec, pack=plan.pack, trace=trace, faults=faults,
            quant=plan.quant, device=self.device)

    @staticmethod
    def _as_result(res: Dict) -> Dict:
        t = res["timing"]
        return _result(res["logits"], t.t_device, t.t_tx + t.t_server,
                       t.tx_bytes, fault=res.get("fault"),
                       wallclock=res["wallclock"])

    def infer(self, image: np.ndarray) -> Dict:
        """One in-process request."""
        return self._as_result(self._runner.infer(image))

    def infer_many(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """Batched fast path when the plan carries a ``batching`` section:
        requests are fused up to ``max_batch`` ROWS at a time through ONE
        edge call and ONE bucketed cloud call (``CollabRunner.infer_batch``),
        with logits bit-identical to the sequential loop. A single request
        wider than ``max_batch`` rows takes the sequential path."""
        if self.plan.batching is None:
            return super().infer_many(images)
        mb = self.plan.batching.max_batch
        buckets = self.plan.batching.resolved_buckets
        out: List[Dict] = []
        chunk: List[np.ndarray] = []
        chunk_rows = 0

        def flush():
            nonlocal chunk, chunk_rows
            out.extend(self._as_result(r) for r in self._runner.infer_batch(
                chunk, bucket=bucket_for(chunk_rows, buckets)))
            chunk, chunk_rows = [], 0

        for img in images:
            rows = int(np.asarray(img).shape[0])
            if rows > mb:                # wider than any bucket
                if chunk:
                    flush()
                out.append(self.infer(img))
                continue
            if chunk_rows + rows > mb:
                flush()
            chunk.append(img)
            chunk_rows += rows
        if chunk:
            flush()
        return out


class SocketSession(InferenceSession):
    """Edge side of the real-socket deployment. Requires a cloud peer
    (``serve``/``CloudServer``, of either package) listening at the plan's
    link endpoint; ``verify=True`` (default) runs the HELLO digest
    handshake. ``resplit`` moves the partition on the live connection.
    A ``trace`` shapes the edge's uplink against a time-varying link.

    With a fleet-routed plan (``plan.routing`` set) the session builds a
    ``FleetRouter`` over the fleet member ports (or adopts a shared one
    passed as ``router``); ``session.router`` exposes its health stats.
    ``sleep_fn`` replaces the retry-backoff sleep."""

    backend = "socket"

    def __init__(self, plan: DeploymentPlan, *, device: DeviceLike = None,
                 verify: bool = True,
                 host: Optional[str] = None, port: Optional[int] = None,
                 trace: Optional[LinkTrace] = None,
                 faults: Optional[FaultInjector] = None,
                 router: Optional[FleetRouter] = None,
                 sleep_fn=None):
        super().__init__(plan)
        self.device = resolve_device(device)
        if router is None and plan.routing is not None:
            router = FleetRouter(plan.routing, host=host or plan.host)
        #: the fleet router steering this session's connects (None on a
        #: single-server plan)
        self.router = router
        self._client = EdgeClient(
            plan.params, plan.cfg, plan.split, port or plan.port,
            masks=plan.masks,
            link=plan.profile.link if plan.shape_link else None,
            compact=plan.compact, codec=plan.codec, pack=plan.pack,
            host=host or plan.host, timeout=plan.connect_timeout_s,
            plan_digest=plan.digest if verify else None, trace=trace,
            fault_policy=plan.faults, faults=faults, router=router,
            quant=plan.quant, device=self.device,
            **({"sleep_fn": sleep_fn} if sleep_fn is not None else {}))
        if plan.faults is not None and plan.faults.fallback == "edge":
            # run the c=N pair once so the first edge-only fallback meets
            # no cold shape in the middle of an outage
            self._client.warm([len(plan.cfg.layers)])

    def resplit(self, split: int) -> None:
        """Move the partition on the live connection (RESPLIT + ack)."""
        self._client.resplit(split)
        self.split = split

    def infer(self, image: np.ndarray) -> Dict:
        """One synchronous request/response on the live socket; measured
        wall-clock timing (seconds)."""
        res = self._client.infer(image)
        return _result(res["logits"], res["t_edge"],
                       res["t_net_and_cloud"], res["tx_bytes"],
                       fault=res.get("fault"))

    def infer_many(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """Pipelined submit/collect: edge compute of request i+1 overlaps
        network + cloud time of request i. Results in submission order."""
        for img in images:
            self._client.submit(img)
        out = self._client.collect(len(images))
        return [_result(r["logits"], r["t_edge"], None, r["tx_bytes"],
                        fault=r.get("fault"))
                for r in out]

    def close(self) -> None:
        """Drain any pipelined requests and close the TCP connection."""
        self._client.close()


def connect(plan: DeploymentPlan, backend: str = "local",
            device: DeviceLike = None, **opts) -> InferenceSession:
    """Open a session on ``plan``. ``device=None`` means the CUDA card (and
    raises without one); pass ``device="cpu"`` to run on the CPU. Extra
    ``opts`` are backend-specific (see each session class)."""
    if backend == "local":
        return LocalSession(plan, device=device, **opts)
    if backend == "socket":
        return SocketSession(plan, device=device, **opts)
    if backend == "streaming":
        raise NotImplementedError(
            f"backend 'streaming' is not ported yet: {NEXT_SLICE} (use "
            f"'local' or 'socket')")
    raise ValueError(f"unknown backend {backend!r} (use {BACKENDS})")


def serve(plan: DeploymentPlan, *, port: Optional[int] = None,
          host: Optional[str] = None, max_requests: Optional[int] = None,
          max_clients: Optional[int] = 1,
          ready: Optional[threading.Event] = None,
          stop: Optional[threading.Event] = None,
          verify: bool = True,
          trace: Optional[LinkTrace] = None,
          batch_stats: Optional[Dict] = None,
          simulate_server=None,
          faults: Optional[FaultInjector] = None,
          fault_stats: Optional[Dict] = None,
          die: Optional[threading.Event] = None,
          drain: Optional[threading.Event] = None,
          device: DeviceLike = None) -> None:
    """Cloud-side entry point: serve ``plan`` on its link endpoint
    (blocking), the cloud half on ``device`` (the card by default).
    ``max_clients=None`` + a ``stop`` event serves many edges until told
    to quit; ``verify`` arms the HELLO digest check. RESPLIT is answered
    for any split valid on the deployed network. A plan with a
    ``batching`` section serves through the dynamic batching engine
    (``batch_stats`` receives its per-lane accounting on shutdown); a
    plan with a ``faults`` section arms sealed frames, idle-client
    reaping and the graceful drain. ``faults`` (a ``FaultInjector``)
    injects the schedule into the server's responses, ``fault_stats``
    receives classified error counts, ``die`` is the crash switch and
    ``drain`` the rolling-restart switch (see ``serve_cloud``)."""
    _refuse_unported(plan)
    serve_cloud(plan.params, plan.cfg, plan.split, port or plan.port,
                masks=plan.masks,
                link=plan.profile.link if plan.shape_link else None,
                max_requests=max_requests, ready=ready,
                compact=plan.compact, host=host or plan.host,
                max_clients=max_clients, stop=stop,
                plan_digest=plan.digest if verify else None,
                trace=trace, batching=plan.batching,
                batch_stats=batch_stats, simulate_server=simulate_server,
                fault_policy=plan.faults, faults=faults,
                fault_stats=fault_stats, die=die, drain=drain,
                quant=plan.quant, device=resolve_device(device))


class CloudServer:
    """Background cloud peer for a plan (thread wrapper around ``serve``),
    on ``device`` (the card by default). A server that fails to start
    (no card, a kernel that does not build, a port in use) raises its
    error here.

    >>> with CloudServer(plan, max_clients=None) as srv:
    ...     sess = connect(plan, backend="socket")
    """

    def __init__(self, plan: DeploymentPlan, *,
                 port: Optional[int] = None, host: Optional[str] = None,
                 max_requests: Optional[int] = None,
                 max_clients: Optional[int] = None, verify: bool = True,
                 start_timeout: float = 60.0,
                 trace: Optional[LinkTrace] = None,
                 simulate_server=None,
                 faults: Optional[FaultInjector] = None,
                 device: DeviceLike = None):
        _refuse_unported(plan)
        self.plan = plan
        self.device = resolve_device(device)
        #: per-lane dynamic-batching accounting (filled on shutdown when
        #: the plan carries a ``batching`` section)
        self.batch_stats: Dict = {}
        #: classified server-side error counts
        self.fault_stats: Dict = {}
        self._stop = threading.Event()
        self._die = threading.Event()
        self._drain = threading.Event()
        self._error: Optional[BaseException] = None
        ready = threading.Event()
        kwargs = dict(port=port, host=host, max_requests=max_requests,
                      max_clients=max_clients, ready=ready, stop=self._stop,
                      verify=verify, trace=trace,
                      batch_stats=self.batch_stats,
                      simulate_server=simulate_server, faults=faults,
                      fault_stats=self.fault_stats, die=self._die,
                      drain=self._drain, device=self.device)

        def run() -> None:
            try:
                serve(plan, **kwargs)
            except BaseException as e:      # noqa: BLE001
                self._error = e
                ready.set()
                raise
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(start_timeout):
            raise TimeoutError("cloud server failed to start listening")
        if self._error is not None:
            raise RuntimeError("cloud server failed to start") \
                from self._error

    def stop(self, timeout: float = 10.0) -> None:
        """Signal the serve loop to quit and join its thread (seconds): a
        *graceful drain*; fills ``batch_stats`` when the plan batches."""
        self._stop.set()
        self._thread.join(timeout)

    def drain(self) -> None:
        """Start a rolling-restart drain: new data requests get the DRAIN
        frame while handshakes and in-flight work still complete."""
        self._drain.set()

    @property
    def draining(self) -> bool:
        """True once a rolling-restart drain has been started."""
        return self._drain.is_set()

    def kill(self, timeout: float = 10.0) -> None:
        """Simulated cloud death: hard-close every connection (clients see
        a reset mid-stream) and join the serve thread."""
        self._die.set()
        self._stop.set()
        self._thread.join(timeout)

    def join(self, timeout: float = 30.0) -> None:
        """Wait for a bounded server (``max_clients`` set) to drain."""
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "CloudServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class CloudFleet:
    """The high-availability cloud tier: one background ``CloudServer``
    per fleet member port in ``plan.routing``, plus the chaos controls —
    ``kill`` (crash a member), ``drain`` (rolling restart: fleet-routed
    edges migrate with zero failed requests), ``restart`` (heal a member
    back into the ring).

    >>> with CloudFleet(plan) as fleet:
    ...     sess = connect(plan, backend="socket")   # routes by lane
    ...     fleet.kill(plan.routing.ports[0])        # edges re-route
    """

    def __init__(self, plan: DeploymentPlan, *, verify: bool = True,
                 max_clients: Optional[int] = None,
                 simulate_server=None, start_timeout: float = 60.0,
                 device: DeviceLike = None):
        if plan.routing is None or not plan.routing.ports:
            raise ValueError(
                "CloudFleet needs a plan with a routing section "
                "(fleet member ports)")
        self.plan = plan
        self._verify = verify
        self._max_clients = max_clients
        self._simulate_server = simulate_server
        self._start_timeout = start_timeout
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._servers: Dict[int, CloudServer] = {}
        for p in plan.routing.ports:
            self._servers[p] = self._spawn(p)

    def _spawn(self, port: int) -> CloudServer:
        return CloudServer(
            self.plan, port=port, max_clients=self._max_clients,
            verify=self._verify, simulate_server=self._simulate_server,
            start_timeout=self._start_timeout, device=self.device)

    @property
    def ports(self) -> tuple:
        """The fleet member ports (the plan's routing section)."""
        return self.plan.routing.ports

    def server(self, port: int) -> CloudServer:
        """The current ``CloudServer`` for one member port."""
        with self._lock:
            return self._servers[port]

    def kill(self, port: int, timeout: float = 10.0) -> None:
        """Crash one member: fleet-routed edges see the reset, mark it
        dead and re-route the replayed request."""
        self.server(port).kill(timeout)

    def drain(self, port: int) -> None:
        """Start a rolling-restart drain on one member."""
        self.server(port).drain()

    def stop(self, port: int, timeout: float = 10.0) -> None:
        """Gracefully stop one member (in-flight work flushes)."""
        self.server(port).stop(timeout)

    def restart(self, port: int, timeout: float = 10.0) -> CloudServer:
        """Bring a killed/drained member back: stop whatever is left on
        the port and start a fresh ``CloudServer`` there."""
        old = self.server(port)
        if old.alive:
            old.stop(timeout)
        srv = self._spawn(port)
        with self._lock:
            self._servers[port] = srv
        return srv

    def stop_all(self, timeout: float = 10.0) -> None:
        """Gracefully stop every member of the fleet."""
        with self._lock:
            servers = list(self._servers.values())
        for srv in servers:
            srv.stop(timeout)

    def __enter__(self) -> "CloudFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()
