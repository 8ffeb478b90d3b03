"""Plain PyTorch version of the column-masked GEMM (the reference's
``kernels/masked_matmul/ref.py``): the CPU path, and the yardstick the
CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def masked_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                      col_mask: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N), output columns multiplied by col_mask (N,).

    This is the semantics of a channel-pruned layer under masked
    execution: pruned output channels are exactly zero (fp32
    accumulation; float64 for float64 operands, which gradient checks
    use)."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    out = a.to(acc) @ b.to(acc)
    return (out * col_mask.to(acc)).to(a.dtype)
