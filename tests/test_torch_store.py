"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
the reference's (``repro.checkpoint.store``): a checkpoint written by
either package restores in the other.

* Every registry smoke config's parameters, float32 and bfloat16: the
  port's tree saved by the port restores in the reference's ``restore``
  with a template from the reference's ``init_params`` (its
  ``jax.eval_shape``), bit for bit (bf16 through its float32 widening),
  and the reference's own checkpoint restores in the port with a template
  from the port's ``init_params``. The leaf count, the order and the
  ``treedef`` text are JAX's (``jax.tree_util.tree_flatten``). A hybrid
  run's layers are stacked flat in both trees; only the reference's
  forward groups them.
* A Mamba2 and a Zamba2 model with their AdamW state, after one CPU step
  in each package, cross both ways: the bits, the step count, and the
  other package's ``loss_fn`` on the restored parameters within
  ``LOSS_RTOL32`` of the saving package's.
* A count or a shape that does not match the template raises in both.
* ``interop.save_params`` (a plan's CNN weights) writes the reference
  store's arrays and ``.json`` text.
"""
from __future__ import annotations

import json
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro.models import transformer as rtr
from repro_torch import interop
from repro_torch.checkpoint import store as tstore
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.models import transformer as ttr
from repro_torch.models.layers.ssm import SSMCache
from torch_parity import (LOSS_RTOL32, adamw_step_both, port_batch,
                          tiny_setup, train_batch_np, train_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)


def _same_bits(got, want) -> bool:
    """Equal dtype, shape and bytes (a tensor or an array on each side)."""
    g = (interop.transformer_params_to_reference(got)
         if torch.is_tensor(got) else np.asarray(got))
    w = np.asarray(want)
    return (g.dtype == w.dtype and g.shape == w.shape
            and np.array_equal(g.view(np.uint8), w.view(np.uint8)))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_checkpoint_restores_in_the_reference(arch, dtype, tmp_path):
    cr, _, pn, _ = train_setup(arch, dtype=dtype, masked=False)
    tp = interop.transformer_params_from_reference(pn)
    path = str(tmp_path / "params")
    tstore.save(path, tp, {"arch": arch})
    leaves, treedef = jax.tree_util.tree_flatten(pn)
    with open(path + ".json") as f:
        on_disk = json.load(f)
    assert on_disk == {"treedef": str(treedef), "n_leaves": len(leaves),
                       "meta": {"arch": arch}}
    with np.load(path + ".npz") as data:
        assert all(data[f].dtype != np.uint16 for f in data.files)
    like = jax.eval_shape(lambda: rtr.init_params(cr,
                                                  jax.random.PRNGKey(0)))
    got = rstore.restore(path, like)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == treedef and len(got_leaves) == len(leaves)
    assert all(_same_bits(g, w) for g, w in zip(got_leaves, leaves))
    assert rstore.load_metadata(path) == {"arch": arch}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reference_checkpoint_restores_in_the_port(arch, dtype, tmp_path):
    _, ct, pn, _ = train_setup(arch, dtype=dtype, masked=False)
    path = str(tmp_path / "params")
    rstore.save(path, _to_jax(pn), {"arch": arch})
    like = ttr.init_params(ct, 0, device="cpu")
    got = tstore.restore(path, like)
    flat = tstore.flatten(got)
    want = jax.tree_util.tree_leaves(pn)
    assert len(flat) == len(want) == len(tstore.flatten(like))
    assert tstore.treedef_str(got) == str(jax.tree_util.tree_structure(pn))
    assert all(_same_bits(g, w) for g, w in zip(flat, want))
    assert tstore.load_metadata(path) == {"arch": arch}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_trained_ssm_models_cross_both_ways_with_their_adamw_state(
        arch, tmp_path):
    cr, *_ = train_setup(arch)
    batch = train_batch_np(cr, 2, 12)
    _, ct, _, mn = train_setup(arch)
    _, _, ref, port = adamw_step_both(arch, batch)
    (rp, rs, _), (tp, ts, _) = ref, port
    to_port = interop.transformer_params_from_reference
    masks_t = interop.transformer_masks_from_reference(mn)

    def port_loss(p):
        with torch.no_grad():
            return float(ttr.loss_fn(p, ct, port_batch(batch), masks_t)[0])

    def ref_loss(p):
        return float(rtr.loss_fn(p, cr, _to_jax(batch), _to_jax(mn))[0])

    # the port's trained model and state into the reference
    path = str(tmp_path / "port")
    tstore.save(path, {"params": tp, "opt": ts}, {"step": ts["step"]})
    got = rstore.restore(path, {"params": rp, "opt": rs})
    assert int(got["opt"]["step"]) == ts["step"] == 1
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    tstore.flatten({"params": tp, "opt": ts})):
        assert _same_bits(w, g) if torch.is_tensor(w) else int(g) == w
    want = port_loss(tp)
    assert abs(ref_loss(got["params"]) - want) <= LOSS_RTOL32 * abs(want)
    # the reference's into the port, which steps on from it
    path = str(tmp_path / "ref")
    rstore.save(path, {"params": rp, "opt": rs})
    back = tstore.restore(path, {"params": tp, "opt": ts})
    assert back["opt"]["step"] == 1 and isinstance(back["opt"]["step"], int)
    for g, w in zip(tstore.flatten(back),
                    jax.tree_util.tree_leaves({"params": rp, "opt": rs})):
        assert _same_bits(g, w) if torch.is_tensor(g) else g == int(w)
    want = ref_loss(rp)
    assert abs(port_loss(back["params"]) - want) <= LOSS_RTOL32 * abs(want)
    assert abs(port_loss(to_port(jax.tree_util.tree_map(np.asarray, rp)))
               - port_loss(back["params"])) == 0.0


RefCache = namedtuple("SSMCache", ["conv", "state"])


def test_treedef_text_of_tuples_named_tuples_and_none():
    """The structures a decode cache adds: named tuples, tuples, None and
    Python scalars, printed and ordered as JAX does."""
    a, b = np.zeros((2, 3), np.float32), np.ones(4, np.float32)
    ref = {"runs": [RefCache(a, b), None], "pos": 3, "t": (a,),
           "u": (b, a), "e": []}
    port = {"runs": [SSMCache(torch.from_numpy(a), torch.from_numpy(b)),
                     None], "pos": 3, "t": (torch.from_numpy(a),),
            "u": (torch.from_numpy(b), torch.from_numpy(a)), "e": []}
    leaves, treedef = jax.tree_util.tree_flatten(ref)
    assert tstore.treedef_str(port) == str(treedef)
    got = tstore.flatten(port)
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        assert (np.array_equal(g.numpy(), w) if torch.is_tensor(g)
                else g == w)
    back = tstore.unflatten(port, got)
    assert isinstance(back["runs"][0], SSMCache) and back["runs"][1] is None
    assert isinstance(back["t"], tuple) and back["pos"] == 3


@pytest.mark.parametrize("fault", ["count", "shape"])
def test_a_template_that_does_not_match_raises_in_both(fault, tmp_path):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = str(tmp_path / "ck")
    tstore.save(path, {"w": torch.from_numpy(a), "b": torch.zeros(3)})
    if fault == "count":
        like_t = {"w": torch.zeros(2, 3), "b": torch.zeros(3),
                  "c": torch.zeros(1)}
        like_r = {k: np.zeros(tuple(v.shape), np.float32)
                  for k, v in like_t.items()}
        match = "checkpoint has 2 leaves, template has 3"
    else:
        like_t = {"w": torch.zeros(3, 2), "b": torch.zeros(3)}
        like_r = {"w": np.zeros((3, 2), np.float32),
                  "b": np.zeros(3, np.float32)}
        match = r"leaf 1: shape \(2, 3\) != \(3, 2\)"
    with pytest.raises(ValueError, match=match):
        tstore.restore(path, like_t)
    with pytest.raises(ValueError, match=match):
        rstore.restore(path, like_r)


def test_save_params_writes_the_reference_stores_files(tmp_path):
    """A plan's CNN weights through ``interop.save_params`` (the store)
    and the reference's ``store.save``: the same ``.json`` text and the
    same arrays under the same names; ``restore_params`` reads both."""
    _, cfg_t, params_np, _, _ = tiny_setup()
    port = str(tmp_path / "port")
    ref = str(tmp_path / "ref")
    interop.save_params(port, interop.params_from_reference(params_np),
                        {"k": 1})
    rstore.save(ref, _to_jax(params_np), {"k": 1})
    with open(port + ".json") as f, open(ref + ".json") as g:
        assert f.read() == g.read()
    with np.load(port + ".npz") as p, np.load(ref + ".npz") as r:
        assert p.files == r.files
        assert all(np.array_equal(p[k], r[k]) and p[k].dtype == r[k].dtype
                   for k in r.files)
    for path in (port, ref):
        got = interop.restore_params(path, cfg_t)
        assert all(torch.equal(got[n][k], torch.from_numpy(
            np.asarray(params_np[n][k]))) for n in params_np
            for k in params_np[n])
