"""Mesh construction on ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

Single pod : (16, 16)      axes ("data", "model")        = 256 ranks
Multi-pod  : (2, 16, 16)   axes ("pod", "data", "model") = 512 ranks

Functions, not module constants: importing this module touches no device
and starts no process group. ``make_production_mesh`` runs over the
process group that already exists (a fake one for a dry run);
``make_host_mesh`` takes what this host has and starts a one-process group
when none exists: NCCL on the card, gloo when the caller asks for the CPU,
its store in this process, so no network is needed. ``host_mesh`` is the
context a launcher trains under: the mesh made current
(``sharding.constraints.use_mesh``), and the group it started destroyed on
the way out.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.constraints import use_mesh


def _device_type() -> str:
    """The device type of the current group's backend: ``cuda`` for
    NCCL, ``cpu`` for gloo and the fake group."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None, pod_axis: bool = False):
    """A (1, n) ("data", "model") mesh over this host's process group (the
    card unless the caller asks for the CPU), starting a one-process group
    (NCCL on the card, gloo on the CPU) when none exists; with
    ``pod_axis``, a (1, 1, n) ("pod", "data", "model") mesh, the pipeline's
    (``core.partition.pod_pipeline``) with one pod."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if _device_type() != dev.type:
        raise RuntimeError(f"the process group's backend "
                           f"{dist.get_backend()!r} does not drive "
                           f"{dev.type}")
    if pod_axis:
        return init_device_mesh(dev.type, (1, 1, dist.get_world_size()),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_mesh(device: DeviceLike = None, pod_axis: bool = False) -> Iterator:
    """``make_host_mesh`` as the current mesh for the duration; a group it
    started is destroyed on exit."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device, pod_axis)
        with use_mesh(mesh):
            yield mesh
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
