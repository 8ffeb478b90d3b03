"""Device resolution and the fp32 numerics of the serving path."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when a CUDA device is wanted (by default or by
    name) and none is present, instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return dev


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors of one shape are the same memory, compared by
    storage and offset (which a fake tensor has too) and not by data
    pointer (which a fake tensor does not)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


_fp32_lock = threading.Lock()
#: threads inside ``exact_fp32`` now, and the switches the first one found
_fp32_state = {"depth": 0, "prev": None}


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Run fp32 convolutions and GEMMs in full fp32, as the JAX reference
    does. cuDNN runs fp32 convolutions in TF32 by default, which keeps only
    about three decimal digits; both switches are set off for the duration
    and restored after. The switches are global, and a server's threads
    enter and leave this context at any time: they are restored only when
    the last thread inside leaves, so none runs with TF32 on while another
    leaves."""
    with _fp32_lock:
        if _fp32_state["depth"] == 0:
            _fp32_state["prev"] = (torch.backends.cudnn.allow_tf32,
                                   torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _fp32_state["depth"] += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_state["depth"] -= 1
            if _fp32_state["depth"] == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _fp32_state["prev"]


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
