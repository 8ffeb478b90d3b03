"""The port's hand-written CUDA kernels, their wrappers and plain versions.

A wrapper whose kernel has a gradient (``rmsnorm``, ``masked_matmul``,
``flash_attention``) routes through its ``torch.autograd.Function`` only
when ``needs_grad`` says autograd wants its output; otherwise it takes the
serving path as it is. The two wrappers without one (``gated_rmsnorm``,
``ssd_scan``) refuse a card tensor that needs a gradient rather than cut
the graph.
"""
from __future__ import annotations

import torch


def needs_grad(*operands: torch.Tensor) -> bool:
    """True when grad mode is on and an operand requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands)


def refuse_grad(name: str, *operands: torch.Tensor) -> None:
    """Raise for card operands that need a gradient the kernel has not."""
    if needs_grad(*operands):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no gradient yet (SSM and hybrid "
            f"training on the card, ROADMAP A7e)")
