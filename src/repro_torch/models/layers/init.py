"""The weight draw shared by the layers' ``init_*_params``.

A weight is drawn as float32 normals from the caller's generator, scaled
in place (``mul_`` and ``div_`` round exactly as ``w * s`` and ``w / s``)
and cast on its way out. Given ``out``, its slot in a stacked run tensor
(``transformer.init_params`` hands each layer views of its slots), the
cast goes straight into that slot, so a run is built with one float32
tensor alive at a time and no tree of the layer beside the stack. On the
``meta`` device (``gen`` None) it only gives the shape and dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def normal(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
           device, *, mul: Optional[float] = None,
           div: Optional[float] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normals times ``mul`` or over ``div``, in ``dtype`` (in ``out``
    when given, which is returned)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if mul is not None:
        w.mul_(mul)
    if div is not None:
        w.div_(div)
    return w.to(dtype) if out is None else out.copy_(w)


def slot(out, key: str):
    """``out[key]``, or None where the caller gave no slots."""
    return None if out is None else out[key]
