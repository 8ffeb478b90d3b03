"""The traced window: ``torch.profiler`` over the card, reduced to the
numbers the per-layer metrics read.

The harness opens one ``record_function("window")`` span around the
traced work and its own spans (``SPANS``) around each call into the
program; the device's operations come from CUPTI. ``summarize`` gives
the seconds the device was busy in the window (the union of its
operations), its idle gaps named by the harness span open on the host at
the time, and the device seconds of each kernel.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: the harness's own spans, one per kind of call into the program
SPANS = ("prefill", "decode", "stream", "train_step", "traffic")
WINDOW = "window"


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


class Tracer:
    """Profiles the work inside ``with tracer:``; ``summary`` after."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = device
        self.summary: Optional[dict] = None
        self._prof = None

    def __enter__(self) -> "Tracer":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events())
        self._prof = None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_device_op(ev) -> bool:
    """A kernel, copy or set on the card; not the device-side copy of a
    host span that the profiler adds."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if ev.is_user_annotation():
        return False
    return ev.name() not in SPANS and ev.name() != WINDOW


def summarize(events) -> dict:
    """``window_s``, ``busy_s``, ``kernel_s`` (name -> device seconds),
    ``idle_by_span`` (harness span -> idle device seconds while it was
    the innermost one open) from a profiler's event list."""
    window = None
    spans: List[Tuple[int, int, str]] = []
    ops: List[Tuple[int, int, str]] = []
    for ev in events:
        if _is_device_op(ev):
            ops.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif ev.device_type() == torch.autograd.DeviceType.CPU:
            name = ev.name()
            if name == WINDOW:
                window = (ev.start_ns(), ev.end_ns())
            elif name in SPANS:
                spans.append((ev.start_ns(), ev.end_ns(), name))
    if window is None:
        raise RuntimeError("the traced window's span is not in the trace")
    w0, w1 = window
    ops = [(max(s, w0), min(e, w1), n) for s, e, n in ops if e > w0 and s < w1]
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for s, e, n in ops:
        kernel_s[n] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in ops])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernel_s": dict(kernel_s),
            "idle_by_span": _idle_by_span(gaps, spans)}


def _idle_by_span(gaps, spans) -> Dict[str, float]:
    """Each idle gap's seconds under the harness span open at its
    midpoint ("none" where none was). The harness's spans do not nest,
    so the last one to start before the midpoint is the only
    candidate."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid) - 1
        name = spans[j][2] if j >= 0 and spans[j][1] >= mid else "none"
        out[name] += (g1 - g0) * 1e-9
    return dict(out)


def kernel_seconds(summary: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name contains ``pattern``."""
    return sum(s for n, s in summary["kernel_s"].items() if pattern in n)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle seconds by
    host span, at most ``top`` of each."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
