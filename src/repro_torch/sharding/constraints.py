"""Activation sharding constraints in model code, the port of the JAX
package's ``sharding/constraints.py``.

``maybe_constrain(x, P(...))`` states the layout model code prefers for
an activation. It does nothing outside a mesh (``use_mesh``, the
counterpart of JAX's ``with mesh:``; ``launch.mesh`` enters it) and
nothing to a plain tensor: the port's model code runs on each rank's
local tensors, since the kernels take plain tensors, so inside the
sharded train step every call is the identity. On a DTensor it
redistributes to the spec's placements, after dropping the mesh axes the
current mesh lacks or that ``declared_manual_axes`` has taken, as the
reference drops them.
"""
from __future__ import annotations

import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the current mesh of this thread
    for the duration."""
    old = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = old


def current_mesh():
    """The mesh ``use_mesh`` made current in this thread, or None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def declared_manual_axes(*names):
    """Mark mesh axes as taken by the caller (the reference's shard_map
    bodies declare theirs): constraints leave them alone."""
    old = getattr(_local, "axes", ())
    _local.axes = old + tuple(names)
    try:
        yield
    finally:
        _local.axes = old


def _current_axes():
    mesh = current_mesh()
    if mesh is None:
        return ()
    declared = getattr(_local, "axes", ())
    return tuple(n for n in mesh.mesh_dim_names if n not in declared)


def maybe_constrain(x, spec):
    """``x`` laid out by ``spec`` where ``x`` is a DTensor inside a mesh;
    ``x`` itself otherwise, or when no axis of ``spec`` survives."""
    axes = _current_axes()
    if not axes:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.specs import P, placements
    axes = tuple(a for a in axes if a in x.device_mesh.mesh_dim_names)
    fixed = []
    changed = False
    want = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
    for ax in want[:x.dim()]:
        parts = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        if parts and all(a in axes for a in parts):
            fixed.append(ax)
            changed = True
        else:
            fixed.append(None)
    if not changed:
        return x
    return x.redistribute(x.device_mesh,
                          placements(P(*fixed), x.device_mesh))


def data_axes_spec():
    """The batch axis of the current mesh: ("pod", "data"), "data", or
    None outside a mesh."""
    axes = _current_axes()
    if "pod" in axes and "data" in axes:
        return ("pod", "data")
    if "data" in axes:
        return "data"
    return None
