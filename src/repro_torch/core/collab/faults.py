"""Fault-tolerance policy and the per-request fault record (a copy of part
of the JAX package's ``repro.core.collab.faults``).

- ``FaultPolicy`` — the serializable recovery contract carried as the
  ``faults`` section of a ``DeploymentPlan``: retry budget, exponential
  backoff with deterministic jitter, a per-request deadline, heartbeat
  interval, and what to do when the budget runs out (edge-only fallback
  or a raised error). The port's plan keeps that section as JSON and
  ``connect`` refuses it until the socket slice ports the retry
  machinery; the class is here so the static analysis gate's
  unit-suffix check holds for this path as it does for the reference's.
- ``fault_record`` — the uniform per-request ``{faults, retries,
  migrations, fallback}`` accounting every backend attaches to its
  results.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Optional

#: what to do when the retry budget / deadline is exhausted
FALLBACK_MODES = ("edge", "fail")


def fault_record(faults: int = 0, retries: int = 0,
                 fallback: bool = False,
                 migrations: int = 0) -> Dict[str, object]:
    """The uniform per-request fault accounting record all backends
    report: ``faults`` = failures observed serving this request,
    ``retries`` = recovery attempts spent, ``migrations`` = DRAIN/BUSY
    reroutes to another fleet member, ``fallback`` = True when the
    request was served edge-only after exhausting the retry budget."""
    return {"faults": int(faults), "retries": int(retries),
            "migrations": int(migrations), "fallback": bool(fallback)}


@dataclass(frozen=True)
class FaultPolicy:
    """Serializable recovery contract for a collaborative deployment.

    Fields (units spelled out, all keys unit-suffixed in JSON):

    - ``max_retries``: recovery attempts per request after the first
      failure; 0 means fail (or fall back) on the first fault.
    - ``backoff_base_s`` / ``backoff_max_s``: exponential backoff —
      attempt k sleeps ``min(base * 2**k, max)`` seconds before
      reconnecting.
    - ``backoff_jitter``: multiplicative jitter fraction in [0, 1];
      each sleep is scaled by ``1 + jitter * u`` with ``u ~ U[0, 1)``
      drawn from a ``seed``-ed RNG, so backoff timing is deterministic
      per client while still de-synchronizing a fleet.
    - ``request_deadline_s``: wall-clock budget for one request
      including all retries; also applied as the socket read timeout,
      so a dead cloud raises ``RequestTimeout`` instead of hanging.
    - ``heartbeat_s``: edge keepalive interval; 0 disables. A cloud
      serving this policy reaps clients silent for
      ``3 * heartbeat_s``.
    - ``fallback``: ``"edge"`` serves the request locally from the
      c=N split pair when retries exhaust (bit-identical logits to an
      all-edge deployment); ``"fail"`` re-raises the last error.
    - ``seed``: RNG seed for the jitter draws.
    """
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.5
    request_deadline_s: float = 10.0
    heartbeat_s: float = 0.0
    fallback: str = "edge"
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff times must be >= 0")
        if not 0.0 <= self.backoff_jitter <= 1.0:
            raise ValueError("backoff_jitter must be in [0, 1]")
        if self.request_deadline_s <= 0:
            raise ValueError("request_deadline_s must be > 0")
        if self.heartbeat_s < 0:
            raise ValueError("heartbeat_s must be >= 0")
        if self.fallback not in FALLBACK_MODES:
            raise ValueError(f"fallback must be one of {FALLBACK_MODES}")

    def attempt_timeout_s(self) -> float:
        """Socket read timeout for ONE attempt: the per-request deadline
        split across the first try plus every retry, so a lost response
        burns one attempt's slice of the budget — not all of it — and
        the remaining slices still fit the replays. (A policy with no
        retries reads with the full deadline.)"""
        return self.request_deadline_s / (self.max_retries + 1)

    def make_rng(self) -> random.Random:
        """A fresh deterministic RNG for this policy's jitter draws."""
        return random.Random(self.seed)

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Seconds to sleep before recovery attempt ``attempt``
        (0-based): capped exponential backoff plus deterministic
        jitter from ``rng`` (jitter-free when ``rng`` is None)."""
        base = min(self.backoff_base_s * (2.0 ** attempt),
                   self.backoff_max_s)
        if rng is None or self.backoff_jitter == 0.0:
            return base
        return base * (1.0 + self.backoff_jitter * rng.random())

    def to_json(self) -> Dict[str, object]:
        """Plain-dict form for ``plan.json`` and the digest fold."""
        return {
            "max_retries": self.max_retries,
            "backoff_base_s": self.backoff_base_s,
            "backoff_max_s": self.backoff_max_s,
            "backoff_jitter": self.backoff_jitter,
            "request_deadline_s": self.request_deadline_s,
            "heartbeat_s": self.heartbeat_s,
            "fallback": self.fallback,
            "seed": self.seed,
        }

    @classmethod
    def from_json(cls, doc: Dict[str, object]) -> "FaultPolicy":
        """Rebuild a policy from its ``to_json`` dict."""
        return cls(
            max_retries=int(doc.get("max_retries", 3)),
            backoff_base_s=float(doc.get("backoff_base_s", 0.05)),
            backoff_max_s=float(doc.get("backoff_max_s", 2.0)),
            backoff_jitter=float(doc.get("backoff_jitter", 0.5)),
            request_deadline_s=float(doc.get("request_deadline_s", 10.0)),
            heartbeat_s=float(doc.get("heartbeat_s", 0.0)),
            fallback=str(doc.get("fallback", "edge")),
            seed=int(doc.get("seed", 0)),
        )
