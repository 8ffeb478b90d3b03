"""The local serving backend: the in-process half of the JAX package's
``serving/session.py`` (``_result``, ``LocalSession``, ``connect``).

It lives beside the future ``session.py`` rather than in it: the static
analysis gate matches ``serving/session.py`` by path and expects the cloud
fleet's state there, so the socket slice folds this file into
``session.py`` when it ports the whole.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.collab.faults import fault_record
from repro_torch.core.collab.local_runtime import CollabRunner
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.plan import DeploymentPlan

BACKENDS = ("local", "socket", "streaming")
#: backends of the reference that later slices port
UNPORTED_BACKENDS = ("socket", "streaming")


def _result(logits, t_edge: float, t_upstream: float, tx_bytes: int,
            wallclock: Dict[str, float]) -> Dict:
    """The reference's result shape — ``t_*`` seconds, ``tx_bytes`` bytes,
    ``e_edge_j`` joules (None: no energy section is served yet), ``fault``
    the ``{faults, retries, migrations, fallback}`` record (all zero: the
    local backend injects no faults) — plus the measured ``wallclock``
    seconds of the edge and cloud halves."""
    return {"logits": np.asarray(logits), "t_edge": t_edge,
            "t_upstream": t_upstream, "t_total": t_edge + t_upstream,
            "tx_bytes": tx_bytes, "e_edge_j": None,
            "fault": fault_record(), "wallclock": wallclock}


class LocalSession:
    """In-process split executor on one device. ``t_edge``/``t_upstream``
    come from the analytic hardware profile when ``simulate_compute`` (the
    default), else from the measured wall-clock of each half; the channel
    term is always charged per transmitted byte."""

    backend = "local"

    def __init__(self, plan: DeploymentPlan, *, device: DeviceLike = None,
                 simulate_compute: bool = True):
        unported = plan.unported_sections()
        if unported:
            raise NotImplementedError(
                f"the plan carries section(s) {unported} that the PyTorch "
                f"port does not serve yet")
        self.plan = plan
        self.device = resolve_device(device)
        self._runner = CollabRunner(
            plan.params, plan.cfg, plan.split, plan.profile,
            masks=plan.masks, simulate_compute=simulate_compute,
            compact=plan.compact, codec=plan.codec, pack=plan.pack,
            quant=plan.quant, device=self.device)

    def infer(self, image: np.ndarray) -> Dict:
        """Serve one request (image ``(B, H, W, C)`` float32)."""
        res = self._runner.infer(image)
        t = res["timing"]
        return _result(res["logits"], t.t_device, t.t_tx + t.t_server,
                       t.tx_bytes, res["wallclock"])

    def infer_many(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """Serve requests one after another."""
        return [self.infer(img) for img in images]

    def close(self) -> None:
        """In-process: nothing to release."""

    def __enter__(self) -> "LocalSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(plan: DeploymentPlan, backend: str = "local",
            device: DeviceLike = None, **opts) -> LocalSession:
    """Open a session on ``plan``. ``device=None`` means the CUDA card (and
    raises without one); pass ``device="cpu"`` to run on the CPU. Extra
    ``opts`` go to ``LocalSession``."""
    if backend == "local":
        return LocalSession(plan, device=device, **opts)
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (use 'local')")
    raise ValueError(f"unknown backend {backend!r} (use {BACKENDS})")
