"""Plain PyTorch version of the flash-attention kernel (the reference's
``kernels/flash_attention/ref.py``): materialising softmax attention with
causal / sliding-window masks and GQA head grouping. The CPU path, and the
yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) with H % Hkv == 0 -> (B,Sq,H,D).

    Key positions are 0..Sk-1 and query row i sits at ``q_offset + i``
    (0 for self-attention; a sequence block's first position where its
    queries attend every key before them). fp32 math (float64 for float64 operands, which
    gradient checks use), output in q's dtype. The (B, H, Sq,
    Sk) scores are scaled and masked in place and released once the
    softmax is taken (the same numbers as out-of-place ops give): at 8192
    tokens they are 8.6 GB a layer at 32 heads."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(acc).reshape(B, Sq, Hkv, group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)).mul_(scale)
    d = (torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
         - torch.arange(Sk, device=q.device)[None, :])
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    probs = torch.softmax(logits.masked_fill_(~ok, NEG_INF), dim=-1)
    del logits
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(acc))
    return out.reshape(B, Sq, H, D).to(q.dtype)
