"""Weights carried between the JAX package and the port.

In memory: a parameter tree of the reference (``{"l{i}": {"w", "b"}}`` of
numpy or JAX arrays, HWIO conv weights, ``(din, dout)`` dense weights)
becomes the port's dict of CPU tensors in the same layout, and back, with
no change to a single value. The transformer's tree (``{"embed",
"final_norm", "lm_head", "runs": [stacked per-run dicts]}``) and its
per-run pruning masks cross the same way (``transformer_params_*``,
``transformer_masks_from_reference``), and so do decode caches, whose
named tuples keep their fields. A bfloat16 leaf arrives from JAX as
numpy's ``bfloat16`` extension type, which ``torch.from_numpy`` refuses: it
crosses as its 16-bit pattern (a ``uint16`` view), bit for bit.

On disk: the reference's checkpoint format, through the port's own
``checkpoint.store`` — ``<path>.npz`` holding the leaves as ``a0..aN`` in
JAX's tree-flatten order, which sorts dict keys as strings (``l0, l10,
l14, l16, l18, l3, l6, l8``, ``b`` before ``w``), plus ``<path>.json``
with the tree structure's text, the leaf count and free metadata; so a
plan directory saved by either package loads in the other.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import CNNConfig
from repro_torch.models.cnn import param_shapes
from repro_torch.models.layers.attention import KVCache, MLACache
from repro_torch.models.layers.ssm import SSMCache

Params = Dict[str, Dict[str, torch.Tensor]]


def params_from_reference(tree) -> Params:
    """Reference parameter tree (numpy or JAX arrays) -> the port's dict
    of CPU tensors, values and layout unchanged."""
    return {name: {leaf: torch.from_numpy(np.array(arr, copy=True))
                   for leaf, arr in layer.items()}
            for name, layer in tree.items()}


def params_to_reference(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's parameters -> a reference tree of numpy arrays."""
    return {name: {leaf: t.detach().cpu().numpy()
                   for leaf, t in layer.items()}
            for name, layer in params.items()}


def _tensor_from_reference(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16), copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tensor_to_reference(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError("a bfloat16 array needs numpy's bfloat16 type, "
                        "which importing JAX (or ml_dtypes) registers") from e
    return t.view(torch.uint16).numpy().view(bf16)


#: the port's cache tuples, by name: a reference cache (``KVCache``,
#: ``MLACache``, ``SSMCache`` of its own modules) arrives as the port's
_CACHES = {c.__name__: c for c in (KVCache, MLACache, SSMCache)}


def _map_tree(fn, tree, caches=None):
    """``fn`` over every leaf of nested dicts, lists and tuples. A named
    tuple keeps its fields: it becomes ``caches``' class of its name where
    given, else stays its own class (the reference reads a cache by field,
    so the port's ``MLACache`` serves it as its own does)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, caches) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = (caches or {}).get(type(tree).__name__, type(tree))
        return cls(*(_map_tree(fn, v, caches) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v, caches) for v in tree]
    return None if tree is None else fn(tree)


def transformer_params_from_reference(tree) -> Dict[str, Any]:
    """Reference transformer tree (numpy or JAX arrays, any dtype incl.
    bfloat16) -> the same tree of CPU tensors, bit for bit. A decode cache
    (``{"runs": [cache tuples], "pos"}``) crosses the same way, each cache
    tuple as the port's class of its name."""
    return _map_tree(_tensor_from_reference, tree, _CACHES)


def transformer_params_to_reference(params) -> Dict[str, Any]:
    """The port's transformer tree (or decode cache) -> the same tree of
    numpy arrays (bfloat16 as numpy's ``bfloat16`` type), bit for bit."""
    return _map_tree(_tensor_to_reference, params)


def transformer_masks_from_reference(masks) -> Optional[List[Any]]:
    """Reference per-run masks (a list of ``None`` or ``{axis: (count,
    n_units)}``) -> the same list of CPU tensors."""
    return None if masks is None else _map_tree(_tensor_from_reference,
                                                masks)


def save_params(path: str, params,
                metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``<path>.npz`` + ``<path>.json`` in the reference's format
    (``checkpoint.store.save``)."""
    store.save(path, params, metadata)


def restore_params(path: str, cfg: CNNConfig) -> Params:
    """Read ``<path>.npz`` into the parameter structure of ``cfg``,
    checking the leaf count and every shape as the reference's
    ``store.restore`` does, and casting to ``cfg.dtype``."""
    dtype = getattr(torch, cfg.dtype)
    template = {name: {leaf: torch.empty(shape, dtype=dtype)
                       for leaf, shape in layer.items()}
                for name, layer in param_shapes(cfg).items()}
    return store.restore(path, template)
