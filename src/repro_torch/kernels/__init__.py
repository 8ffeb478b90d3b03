"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Every wrapper whose kernel lies on a training path (``rmsnorm`` and its
gated entry, ``masked_matmul``, ``flash_attention``, ``ssd_scan``) routes
through its ``torch.autograd.Function`` only when ``needs_grad`` says
autograd wants its output; otherwise it takes the serving path as it is.
"""
from __future__ import annotations

import torch


def needs_grad(*operands: torch.Tensor) -> bool:
    """True when grad mode is on and an operand requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands)
