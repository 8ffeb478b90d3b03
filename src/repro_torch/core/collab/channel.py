"""Bandwidth-shaped byte channels standing in for the paper's Wi-Fi hop
(a copy of the JAX package's ``repro.core.collab.channel``).

``SimChannel`` computes transmission time analytically on a virtual clock;
it never sleeps (a caller that wants real-time pacing sleeps the returned
cost itself, as ``runtime.CollabRunner`` does with
``realtime_channel=True``). ``ShapedSocket`` wraps a real TCP socket with a
token-bucket rate limiter; ``runtime.serve_cloud`` and
``runtime.EdgeClient`` send through it.

Both channels accept a ``LinkTrace`` (``repro_torch.core.partition.profiles``)
for *time-varying* links: ``SimChannel`` keeps a virtual clock and charges
each transmission piecewise against the trace segments it straddles (a
send that starts on 50 Mbps and ends on 5 Mbps pays exactly the blended
cost), while ``ShapedSocket`` refills its token bucket at whatever rate
the trace dictates at the current wall-clock offset. The per-send cost is
therefore a *measurement* of the link as it is right now — the signal the
adaptive split controller estimates bandwidth from.

Both channels also accept a ``FaultInjector`` replaying a deterministic
``FaultSchedule`` (``repro_torch.core.partition.profiles``): ``SimChannel``
charges lost copies and ARQ retransmissions against the virtual clock,
while ``ShapedSocket`` drops, corrupts, stalls, or tears down real
frames on the wire — the reproducible storm the recovery machinery in
``repro_torch.core.collab.faults`` is tested against.
"""
from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.partition.profiles import (FaultEvent, FaultSchedule,
                                           LinkProfile, LinkTrace)


def recv_exact(sock: socket.socket, n: int, chunk: int = 1 << 20) -> bytes:
    """Read exactly n bytes from a connected socket.

    ``sock.recv(n, MSG_WAITALL)`` may still return short (signal delivery,
    platform quirks, very large n), so every frame read — shaped or not —
    goes through this loop instead.
    """
    out = bytearray()
    while len(out) < n:
        got = sock.recv(min(chunk, n - len(out)))
        if not got:
            raise EOFError("peer closed")
        out += got
    return bytes(out)


def corrupt_bytes(data: bytes, index: Optional[int] = None) -> bytes:
    """Flip one byte of ``data`` (the middle byte by default).

    Deterministic by design — the corrupt-frame tests assert that the
    CRC layer catches *this exact* flip, not a random one.
    """
    if not data:
        return data
    i = len(data) // 2 if index is None else index
    return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]


class FaultInjector:
    """Replays a ``FaultSchedule`` against a live attempt counter.

    The schedule is pure data; the injector owns the mutable state — a
    thread-safe, monotonically increasing transmission-attempt index and
    per-kind fault counts. One injector drives one run; build a fresh
    one to replay the same schedule again.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._lock = threading.Lock()
        self._attempt = 0
        self.counts: Dict[str, int] = {}

    def next_event(self) -> Optional[FaultEvent]:
        """Consume one transmission attempt; the fault to inject on it,
        or None for a clean attempt."""
        with self._lock:
            ev = self.schedule.event_at(self._attempt)
            self._attempt += 1
            if ev is not None:
                self.counts[ev.kind] = self.counts.get(ev.kind, 0) + 1
            return ev

    @property
    def attempts(self) -> int:
        """Transmission attempts consumed so far."""
        with self._lock:
            return self._attempt

    @property
    def injected(self) -> int:
        """Total faults injected so far (all kinds)."""
        with self._lock:
            return sum(self.counts.values())

    def reset(self) -> None:
        """Rewind to attempt 0 and clear the per-kind counts."""
        with self._lock:
            self._attempt = 0
            self.counts = {}


def apply_send_fault(ev: FaultEvent, data: bytes,
                     sock: Optional[socket.socket]) -> Optional[bytes]:
    """Apply one injected fault to an outgoing frame.

    Returns the (possibly corrupted) bytes to put on the wire, or None
    when the frame is dropped. ``disconnect``/``die`` close ``sock``
    and raise ``ConnectionResetError`` — exactly what a torn-down TCP
    connection surfaces to the sender.
    """
    if ev.kind == "drop":
        return None
    if ev.kind == "corrupt":
        return corrupt_bytes(data)
    if ev.kind == "stall":
        time.sleep(ev.stall_s)
        return data
    if sock is not None:
        try:
            sock.close()
        except OSError:
            pass
    raise ConnectionResetError(f"injected fault: {ev.kind}")


@dataclass
class SimChannel:
    """Analytic byte channel with an optional time-varying link.

    With ``trace`` set, ``elapsed_s`` is the virtual deployment clock: each
    ``send`` drains bytes segment-by-segment from the trace starting at the
    current clock, and ``advance`` moves the clock across non-transmission
    time (edge/cloud compute) so the link keeps degrading while the radio
    is idle. Without a trace this is the original fixed-``link`` channel.

    With ``faults`` set, each ``send`` consults the injector: a lost copy
    (drop/corrupt/disconnect — the analytic channel models link-layer
    ARQ) burns a full transmission's airtime and is retransmitted on the
    next attempt index; a stall adds its delay. ``last_send_events``
    records what the most recent ``send`` suffered.
    """
    link: LinkProfile
    trace: Optional[LinkTrace] = None
    sent_bytes: int = 0
    elapsed_s: float = 0.0
    faults: Optional[FaultInjector] = None
    last_send_events: Tuple[str, ...] = ()

    def link_now(self) -> LinkProfile:
        """The link state at the current virtual clock."""
        if self.trace is None:
            return self.link
        return self.trace.link_at(self.elapsed_s)

    def advance(self, dt: float) -> None:
        """Advance the virtual clock without transmitting (compute time)."""
        if dt > 0:
            self.elapsed_s += dt

    def _trace_send_time(self, nbytes: int) -> float:
        bw, rtt, _ = self.trace.span_at(self.elapsed_s)
        t, now, remaining = rtt, self.elapsed_s + rtt, float(nbytes)
        while remaining > 0:
            bw, _, span = self.trace.span_at(now)
            can = bw * span                 # bytes this segment can carry
            if can >= remaining:
                dt = remaining / bw
                remaining = 0.0
            else:
                dt = span
                remaining -= can
            t += dt
            now += dt
        return t

    def _one_send(self, nbytes: int) -> float:
        if self.trace is None:
            t = nbytes / self.link.bandwidth + self.link.rtt_s
        else:
            t = self._trace_send_time(nbytes)
        self.sent_bytes += nbytes
        self.elapsed_s += t
        return t

    def send(self, nbytes: int) -> float:
        events = []
        t = 0.0
        if self.faults is not None:
            ev = self.faults.next_event()
            while ev is not None:
                events.append(ev.kind)
                if ev.kind == "stall":
                    self.elapsed_s += ev.stall_s
                    t += ev.stall_s
                    break               # delayed, then delivered
                t += self._one_send(nbytes)   # lost copy burns airtime ...
                ev = self.faults.next_event()  # ... retransmit = new attempt
        t += self._one_send(nbytes)
        self.last_send_events = tuple(events)
        return t


class LinkShaper:
    """One token bucket modeling one physical link, shareable by many
    sockets.

    A wireless medium is a *shared* resource: every station associated
    with the access point contends for the same airtime. Modeling each
    TCP connection with its own private token bucket therefore multiplies
    the physical link by the number of connections. A ``LinkShaper`` is
    the fix — one bucket per physical medium; every ``ShapedSocket``
    wrapped around it draws tokens from the same budget, so N concurrent
    senders each see ~1/N of the modeled bandwidth.

    ``pace`` is thread-safe; the lock is deliberately held across the
    pacing sleep, which serializes concurrent senders exactly the way a
    busy channel serializes transmissions. With a ``trace``, the refill
    rate follows the trace at the wall-clock offset since construction.
    """

    def __init__(self, link: LinkProfile, trace: Optional[LinkTrace] = None,
                 burst_s: float = 0.05):
        self.link = link
        self.trace = trace
        self.burst_s = burst_s
        self._lock = threading.Lock()
        self._budget = 0.0
        self._t0 = time.perf_counter()
        self._last = self._t0

    def state(self, now: float):
        """(bandwidth, rtt_s) the shaper is enforcing right now."""
        if self.trace is None:
            return self.link.bandwidth, self.link.rtt_s
        return self.trace.state_at(now - self._t0)

    def pace(self, nbytes: int) -> None:
        """Block until the bucket can carry ``nbytes`` more bytes."""
        with self._lock:
            now = time.perf_counter()
            bw = self.state(now)[0]
            self._budget += (now - self._last) * bw
            self._budget = min(self._budget, bw * self.burst_s)
            self._last = now
            if nbytes > self._budget:
                need = (nbytes - self._budget) / bw
                time.sleep(need)
                self._last = time.perf_counter()
                self._budget = 0.0
            else:
                self._budget -= nbytes


class ShapedSocket:
    """Token-bucket pacing on top of a connected socket (both directions).

    By default each ShapedSocket owns a private ``LinkShaper``; pass
    ``shaper=`` to make several sockets contend for one modeled physical
    link (``serve_cloud`` does this — one bucket per server, so N
    concurrent edges share the medium instead of multiplying it).

    ``last_send_cost_s`` is the *modeled* link cost of the most recent
    ``sendall`` (bytes over the shaped bandwidth at send time, plus one
    RTT). The wall-clock a send took is a poor bandwidth signal here — the
    token bucket deliberately lets small frames burst through unpaced — so
    the adaptive estimator reads this modeled cost instead, which tracks
    whatever the (possibly trace-driven) shaper is currently enforcing.

    With ``faults`` set, every ``sendall`` consults the injector (each
    serving-stack ``sendall`` is exactly one wire frame): the frame may
    be dropped, corrupted, stalled, or the socket torn down mid-stream
    (``ConnectionResetError``) — see ``apply_send_fault``.
    """

    def __init__(self, sock: socket.socket, link: LinkProfile,
                 chunk: int = 16384, trace: Optional[LinkTrace] = None,
                 shaper: Optional[LinkShaper] = None,
                 faults: Optional[FaultInjector] = None):
        self.sock = sock
        self.shaper = shaper or LinkShaper(link, trace=trace)
        self.link = self.shaper.link
        self.chunk = chunk
        self.trace = self.shaper.trace
        self.faults = faults
        self.last_send_cost_s = 0.0

    def _state(self, now: float):
        """(bandwidth, rtt_s) the shaper is enforcing right now."""
        return self.shaper.state(now)

    def sendall(self, data: bytes) -> None:
        if self.faults is not None:
            ev = self.faults.next_event()
            if ev is not None:
                maybe = apply_send_fault(ev, data, self.sock)
                if maybe is None:             # frame lost in flight
                    self.last_send_cost_s = 0.0
                    return
                data = maybe
        cost, rtt = 0.0, 0.0
        for i in range(0, len(data), self.chunk):
            piece = data[i:i + self.chunk]
            self.shaper.pace(len(piece))
            self.sock.sendall(piece)
            bw, rtt = self._state(time.perf_counter())
            cost += len(piece) / bw
        self.last_send_cost_s = cost + rtt

    def recv_exact(self, n: int) -> bytes:
        return recv_exact(self.sock, n, self.chunk)

    def close(self) -> None:
        self.sock.close()
