"""Sharding planner: spec trees for params, optimizer state, batches and
caches, per (config, mesh), the port of the JAX package's
``sharding/specs.py`` rule for rule, and their placements on a
``DeviceMesh``.

Strategy (the reference's):
  * 2-D weight sharding: every large matmul weight shards its d_model-side
    dim over the combined data axes (FSDP-style) and its output or expert
    dim over "model" (Megatron-style).
  * The MoE expert dim shards over "model" (expert parallelism).
  * The batch shards over ("pod", "data") / ("data",) when divisible;
    otherwise the sequence, or nothing (B = 1 long-context decode).
  * Norms and scalars replicate.
  * An axis that does not divide its dim falls back to replication on that
    dim (DTensor could shard it unevenly; the reference prefers clean
    layouts).

Rules are name-based over the tree paths, so they apply alike to stacked
runs and to the unstacked ``shared`` and ``mtp`` blocks. A spec is a
``PartitionSpec``: a tuple with one entry per tensor dim (an axis name, a
tuple of names, or None), the same content as the reference's, so the
two compare directly. ``to_shardings`` turns each into (mesh,
placements): a tensor dim over ("pod", "data") is ``Shard(d)`` on both
mesh dims, pod the major one, as JAX lays it out; a mesh dim the spec
does not name is ``Replicate()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def _entry(e):
    """A spec entry as JAX keeps it: a one-name tuple is the name, an
    empty one None."""
    if isinstance(e, tuple) and len(e) <= 1:
        return e[0] if e else None
    return e


class PartitionSpec(tuple):
    """``PartitionSpec("model", None)``: a tuple of per-dim entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------
def path_key(p) -> str:
    """A tree-path element as a string (a dict key, a sequence index or a
    named tuple's field)."""
    return str(p)


def path_keys(path) -> Tuple[str, ...]:
    return tuple(path_key(p) for p in path)


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map_with_path(fn: Callable, tree, *rest, path=(),
                       is_leaf: Callable = None):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of nested dicts,
    lists, tuples and named tuples (a named tuple's path element is its
    field name, as JAX's ``GetAttrKey``); None stays None, an empty
    subtree as in JAX. Every tree in ``rest`` has ``tree``'s structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(
            fn, v, *(r[i] for r in rest), path=path + (f,), is_leaf=is_leaf)
            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(
            fn, v, *(r[i] for r in rest), path=path + (i,), is_leaf=is_leaf)
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


# ---------------------------------------------------------------------------
# mesh axes
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(data_axes, model_axis) of a production mesh."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def _divisible(n: int, mesh, axes) -> bool:
    sizes = axis_sizes(mesh)
    size = int(np.prod([sizes[a] for a in (axes if isinstance(axes, tuple)
                                           else (axes,))]))
    return n % size == 0


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
_COL_NAMES = {"wq", "wk", "wv", "w_up", "w_gate", "w_dq", "w_uq", "w_dkv",
              "w_uk", "w_uv", "w_in", "w_up_sh", "w_gate_sh", "proj"}
_ROW_NAMES = {"wo", "w_down", "w_out", "w_down_sh"}
_BIAS_NAMES = {"bq", "bk", "bv"}
_REPL_NAMES = {"ln1", "ln2", "ln", "final_norm", "q_norm", "kv_norm",
               "norm_scale", "A_log", "dt_bias", "D", "conv_b", "w_router"}


def _leaf_spec(keys, leaf, data, shard_data_dim: bool) -> PartitionSpec:
    name = keys[-1]
    in_moe = "moe" in keys
    nd = len(_shape(leaf))
    dspec = data if shard_data_dim else None

    def lead(base):
        return P(*([None] * (nd - len(base)) + list(base)))

    if name == "embed":
        return P("model", dspec)
    if name == "lm_head":
        return P(dspec, "model")
    if name in _REPL_NAMES:
        return lead([None] * min(nd, 1))
    if name == "conv_w":
        return lead([None, "model"])
    if name in _BIAS_NAMES:
        return lead(["model"])
    if in_moe and name in ("w_up", "w_gate"):
        return lead(["model", dspec, None])
    if in_moe and name == "w_down":
        return lead(["model", None, dspec])
    if name in _COL_NAMES:
        return lead([dspec, "model"])
    if name in _ROW_NAMES:
        return lead(["model", dspec])
    return P()                                  # default: replicate


def param_specs(params, cfg: ModelConfig, mesh, shard_data_dim: bool = True):
    """A spec tree matching ``params`` (tensors of any device, ``meta``
    included, or arrays): each leaf's rule, then every axis that does not
    divide its dim dropped to replication on that dim."""
    data, _ = mesh_axes(mesh)

    def spec_for(path, leaf):
        sp = _leaf_spec(path_keys(path), leaf, data, shard_data_dim)
        dims = _shape(leaf)
        fixed = []
        for dim, ax in zip(dims, tuple(sp) + (None,) * (len(dims) - len(sp))):
            fixed.append(ax if ax is not None and _divisible(dim, mesh, ax)
                         else None)
        return P(*fixed)

    return tree_map_with_path(spec_for, params)


def opt_state_specs(opt_state, pspecs):
    """Optimizer moments (``m``, ``v``, ``mom``) mirror the param specs;
    counters replicate."""
    def match(path, leaf):
        keys = list(path_keys(path))
        if keys and keys[0] in ("m", "v", "mom"):
            node = pspecs
            for k in keys[1:]:
                node = node[int(k)] if isinstance(node, (list, tuple)) \
                    else node[k]
            return node
        return P()
    return tree_map_with_path(match, opt_state)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def batch_specs(batch, cfg: ModelConfig, mesh):
    """The batch dim over the data axes when divisible; else the sequence
    dim; else replicated. ``mrope_positions`` is (3, B, S)."""
    data, _ = mesh_axes(mesh)

    def spec_for(path, leaf):
        name = path_keys(path)[-1]
        shape = _shape(leaf)
        if name == "mrope_positions":           # (3, B, S)
            b_ok = _divisible(shape[1], mesh, data)
            return P(None, data if b_ok else None, None)
        if not shape:
            return P()
        if _divisible(shape[0], mesh, data):
            return P(*([data] + [None] * (len(shape) - 1)))
        # small batch: shard the sequence instead when possible
        if len(shape) >= 2 and _divisible(shape[1], mesh, data):
            return P(*([None, data] + [None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec_for, batch)


def cache_specs(cache, cfg: ModelConfig, mesh):
    """KV / MLA / SSM cache sharding.

    KVCache   (L, B, S, Hkv, D): B over data if divisible, else S over data
              (context parallelism); Hkv over model if divisible, else D.
    MLACache  (L, B, S, rank): B (else S) over data, rank over model.
    SSMCache  conv (L, B, K-1, cdim): cdim over model.
              state (L, B, H, P, N): H over model, B over data.
    pos       replicated.
    """
    data, model = mesh_axes(mesh)

    def spec_for(path, leaf):
        name = path_keys(path)[-1]
        shape = _shape(leaf)
        if name == "pos" or not shape:
            return P()
        if name == "conv":
            return P(*([None] * (len(shape) - 1) + [
                model if _divisible(shape[-1], mesh, model) else None]))
        if name == "state":
            out = [None] * len(shape)
            out[-3] = model if _divisible(shape[-3], mesh, model) else None
            b_idx = len(shape) - 4
            if b_idx >= 0 and _divisible(shape[b_idx], mesh, data):
                out[b_idx] = data
            return P(*out)
        if name in ("k", "v"):                  # (..., B, S, Hkv, D)
            out = [None] * len(shape)
            b_idx, s_idx, h_idx, d_idx = (len(shape) - 4, len(shape) - 3,
                                          len(shape) - 2, len(shape) - 1)
            if _divisible(shape[b_idx], mesh, data):
                out[b_idx] = data
            elif _divisible(shape[s_idx], mesh, data):
                out[s_idx] = data
            if _divisible(shape[h_idx], mesh, model):
                out[h_idx] = model
            elif _divisible(shape[d_idx], mesh, model):
                out[d_idx] = model
            return P(*out)
        if name in ("ckv", "krope"):            # (L, B, S, rank)
            out = [None] * len(shape)
            if _divisible(shape[1], mesh, data):
                out[1] = data
            elif _divisible(shape[2], mesh, data):
                out[2] = data
            if _divisible(shape[-1], mesh, model):
                out[-1] = model
            return P(*out)
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec_for, cache)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------
def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` on every mesh axis that tensor dim d names (several
    axes on one dim shard it major to minor in mesh order, as JAX does),
    ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def to_shardings(specs, mesh):
    """Each spec of ``specs`` as ``(mesh, placements)``."""
    return tree_map_with_path(lambda _, sp: (mesh, placements(sp, mesh)),
                              specs, is_leaf=_is_spec)


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh`` laid out by ``specs``:
    each rank keeps its own slice of the full tensor it holds (no
    communication: every rank must hold the same tree). A leaf whose
    slice is the whole tensor (a one-rank mesh, a replicated leaf) is
    wrapped as it is, without a copy: the DTensor's local tensor *is* the
    caller's tensor, so a write in place through either shows in the
    other, and a caller that keeps its tree must write to neither in
    place (the port's optimizers and steps return new tensors). Other
    leaves (an optimizer's step counter) stay as they are."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(_, sp, t):
        if not torch.is_tensor(t):
            return t
        pl = placements(sp, mesh)
        if local_shape_and_offset(t.shape, sp, mesh)[0] == tuple(t.shape):
            return DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return tree_map_with_path(put, specs, tree, is_leaf=_is_spec)


def local_shape_and_offset(shape, spec: PartitionSpec, mesh):
    """(local shape, global offset) of this rank's slice of a tensor of
    ``shape`` under ``spec`` (``compute_local_shape_and_global_offset``,
    computed outside any fake mode: it is arithmetic on the layout, and
    a traced dry run must not see it)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, offset = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements(spec, mesh))
    return tuple(int(n) for n in local), tuple(int(o) for o in offset)


def local_slice(t, spec: PartitionSpec, mesh):
    """This rank's slice of the full tensor (or array) ``t`` under
    ``spec``, without communication."""
    shape, offset = local_shape_and_offset(_shape(t), spec, mesh)
    return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
