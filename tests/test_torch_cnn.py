"""The port's CNN (``repro_torch.models.cnn``) against the reference's
``repro.models.cnn`` on the same numpy inputs: the forward at every split
(dense, masked and compacted), layer shapes, compaction and the codec's
keep indices."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as rcnn
from repro_torch.models import cnn as tcnn
from torch_parity import (fp32_tol, port_masks, port_params, ref_tree,
                          tiny_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)


def _deployed(variant):
    """(cfg_r, cfg_t, params_r, params_t, masks_r, masks_t, x) for one of
    the three deployments a split model runs as."""
    cfg_r, cfg_t, params, masks, x = tiny_setup()
    if variant == "dense":
        return (cfg_r, cfg_t, ref_tree(params), port_params(params), None,
                None, x)
    if variant == "masked":
        return (cfg_r, cfg_t, ref_tree(params), port_params(params),
                {i: jnp.asarray(m) for i, m in masks.items()},
                port_masks(masks), x)
    cp_r, ccfg_r = rcnn.compact_params(ref_tree(params), cfg_r,
                                       {i: jnp.asarray(m)
                                        for i, m in masks.items()})
    cp_t, ccfg_t = tcnn.compact_params(port_params(params), cfg_t, masks)
    return ccfg_r, ccfg_t, cp_r, cp_t, None, None, x


@pytest.mark.parametrize("variant", ["dense", "masked", "compacted"])
def test_cnn_apply_every_split_matches_reference(variant):
    """Logits and every intermediate, then the edge half [0, c) and the
    cloud half [c, N) at every split c, agree within ``fp32_tol`` (two
    fp32 sums in different orders)."""
    cfg_r, cfg_t, p_r, p_t, m_r, m_t, x = _deployed(variant)
    out_r, inter_r = rcnn.cnn_apply(p_r, cfg_r, jnp.asarray(x), masks=m_r,
                                    return_intermediates=True)
    with torch.no_grad():
        out_t, inter_t = tcnn.cnn_apply(p_t, cfg_t, torch.from_numpy(x),
                                        masks=m_t, return_intermediates=True)
    assert len(inter_t) == len(inter_r) == len(cfg_t.layers)
    for a_t, a_r in zip(inter_t + [out_t], list(inter_r) + [out_r]):
        a_r = np.asarray(a_r)
        assert a_t.shape == a_r.shape
        np.testing.assert_allclose(a_t.numpy(), a_r, rtol=0,
                                   atol=fp32_tol(a_r))
    n = len(cfg_t.layers)
    for c in range(n + 1):
        edge_r = (np.array(rcnn.cnn_apply(p_r, cfg_r, jnp.asarray(x),
                                            masks=m_r, stop_layer=c))
                  if c else x)
        with torch.no_grad():
            edge_t = tcnn.cnn_apply(p_t, cfg_t, torch.from_numpy(x),
                                    masks=m_t, stop_layer=c)
            cloud_t = tcnn.cnn_apply(p_t, cfg_t, torch.from_numpy(edge_r),
                                     masks=m_t, start_layer=c)
        np.testing.assert_allclose(edge_t.numpy(), edge_r, rtol=0,
                                   atol=fp32_tol(edge_r))
        cloud_r = np.asarray(rcnn.cnn_apply(p_r, cfg_r, jnp.asarray(edge_r),
                                            masks=m_r, start_layer=c))
        np.testing.assert_allclose(cloud_t.numpy(), cloud_r, rtol=0,
                                   atol=fp32_tol(cloud_r))


@pytest.mark.parametrize("which", ["tiny", "alexnet"])
def test_layer_shapes_match_reference(which):
    if which == "alexnet":
        cfg_r, cfg_t = rcnn.alexnet_config(38), tcnn.alexnet_config(38)
    else:
        cfg_r, cfg_t = (rcnn.tiny_cnn_config(7, hw=32),
                        tcnn.tiny_cnn_config(7, hw=32))
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
    assert tcnn.layer_shapes(cfg_t) == rcnn.layer_shapes(cfg_r)
    assert tcnn.prunable_layers(cfg_t) == rcnn.prunable_layers(cfg_r)


def test_compact_params_identical_to_reference():
    """Compaction is pure indexing: identical shapes, bit-identical
    values, and the same compacted config (also from the shape-only
    ``compact_cnn_config``)."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    masks_r = {i: jnp.asarray(m) for i, m in masks.items()}
    cp_r, ccfg_r = rcnn.compact_params(ref_tree(params), cfg_r, masks_r)
    cp_t, ccfg_t = tcnn.compact_params(port_params(params), cfg_t, masks)
    assert dataclasses.asdict(ccfg_t) == dataclasses.asdict(ccfg_r)
    assert dataclasses.asdict(tcnn.compact_cnn_config(cfg_t, masks)) == \
        dataclasses.asdict(rcnn.compact_cnn_config(cfg_r, masks_r))
    assert sorted(cp_t) == sorted(cp_r)
    for k in cp_r:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(cp_t[k][leaf].numpy(),
                                          np.asarray(cp_r[k][leaf]))


def test_split_keep_indices_identical_to_reference():
    cfg_r, cfg_t, _, masks, _ = tiny_setup()
    for c in range(len(cfg_t.layers) + 1):
        k_r = rcnn.split_keep_indices(cfg_r, masks, c)
        k_t = tcnn.split_keep_indices(cfg_t, masks, c)
        assert (k_t is None) == (k_r is None), c
        if k_r is not None:
            np.testing.assert_array_equal(k_t, k_r)
