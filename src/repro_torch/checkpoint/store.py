"""Checkpointing: a tree of tensors <-> ``<path>.npz`` + ``<path>.json``,
the reference's format (``repro/checkpoint/store.py``), written and read
without JAX, so that a checkpoint saved by either package restores in the
other. Works for parameters and optimizer state.

The leaves go into the ``.npz`` as ``a0..aN`` in JAX's tree-flatten
order: dict keys sorted, lists and tuples in order, a named tuple's
fields in order, ``None`` holding no leaf. Tensors, numpy arrays and
Python scalars (an optimizer state's ``step``) are leaves. A bfloat16 leaf
is widened to float32, which numpy can store; ``restore`` casts each leaf
back to its template's dtype. The ``.json`` holds ``treedef``, the text
``str(jax.tree_util.tree_flatten(tree)[1])`` gives, ``n_leaves`` and the
caller's ``meta``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's tree-flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def treedef_str(tree) -> str:
    """The text of ``tree``'s structure as JAX prints its ``PyTreeDef``,
    e.g. ``PyTreeDef({'m': [*, None], 'step': *})``."""
    def fmt(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(fmt(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(fmt(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def unflatten(like, leaves: List[Any]):
    """``leaves`` (in ``flatten``'s order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _as_numpy(leaf) -> np.ndarray:
    """A leaf as numpy can store it: bfloat16 widened to float32."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _like(arr: np.ndarray, tmpl):
    """``arr`` as the template leaf's kind, dtype and device."""
    if torch.is_tensor(tmpl):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return np.asarray(arr, dtype=tmpl.dtype)
    if isinstance(tmpl, (bool, int, float)):
        return type(tmpl)(arr)
    return arr


def save(path: str, tree, metadata: Optional[Dict[str, Any]] = None
         ) -> None:
    """Write ``<path>.npz`` (the leaves as ``a0..aN``) and ``<path>.json``
    (``treedef``, ``n_leaves``, ``meta``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = flatten(tree)
    np.savez(path + ".npz", **{f"a{i}": _as_numpy(leaf)
                               for i, leaf in enumerate(leaves)})
    with open(path + ".json", "w") as f:
        json.dump({"treedef": treedef_str(tree),
                   "n_leaves": len(leaves),
                   "meta": metadata or {}}, f)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape and dtype template):
    the leaf count and every shape must match; each leaf takes the
    template's dtype, and a tensor its device."""
    leaves_like = flatten(like)
    leaves = []
    with np.load(path + ".npz") as data:
        n, got = len(leaves_like), len(data.files)
        if got != n:
            raise ValueError(f"checkpoint has {got} leaves, template has "
                             f"{n}")
        for i, tmpl in enumerate(leaves_like):
            arr = data[f"a{i}"]
            if hasattr(tmpl, "shape") and tuple(arr.shape) != tuple(
                    tmpl.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            leaves.append(_like(arr, tmpl))
    return unflatten(like, leaves)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)["meta"]
