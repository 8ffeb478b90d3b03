"""``repro_torch.serving`` — the deployment front door of the port::

    from repro_torch import serving

    plan = serving.DeploymentPlan.from_args(params, cfg, masks=masks,
                                            compact=True, codec="int8",
                                            quant=serving.QuantPolicy(8))
    with serving.connect(plan, backend="local") as sess:   # on the card
        out = sess.infer(image)      # {"logits", "t_edge", "tx_bytes", ...}

Plans are byte-compatible with ``repro.serving``'s (same digest, same
directory layout), so ``DeploymentPlan.load`` reads a plan the JAX package
saved. Only the ``local`` backend is ported so far.
"""
from repro_torch.core.collab.quant import QuantPolicy
from repro_torch.serving.local_session import (BACKENDS, LocalSession,
                                               connect)
from repro_torch.serving.plan import PLAN_VERSION, DeploymentPlan

__all__ = ["BACKENDS", "PLAN_VERSION", "DeploymentPlan", "LocalSession",
           "QuantPolicy", "connect"]
