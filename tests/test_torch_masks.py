"""The port's structured pruning masks (``repro_torch.core.pruning
.masks``) against the reference's on the same parameters: the kept units
must be identical, bit for bit — attention heads and FFN channels of the
dense families, SSD heads of Mamba2 and Zamba2, and the CNN's channels
(the MoE and MLA axes: ``test_torch_moe.py``, ``test_torch_mla.py``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core.pruning import masks as rmasks
from repro_torch.configs import registry as treg
from repro_torch.core.pruning import masks as tmasks
from repro_torch.interop import transformer_params_from_reference
from torch_parity import (port_params, ref_tree, tiny_setup,
                          transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

DENSE = ["qwen2-7b", "qwen1.5-4b", "gemma-7b", "nemotron-4-340b"]


def _setup(arch, dtype, seed=0, **overrides):
    cr = rreg.get_smoke_config(arch).replace(dtype=dtype, **overrides)
    ct = treg.get_smoke_config(arch).replace(dtype=dtype, **overrides)
    pn = transformer_params_np(cr, seed)
    return (cr, ct, jax.tree_util.tree_map(jnp.asarray, pn),
            transformer_params_from_reference(pn))


def _assert_same_masks(mr, mt):
    assert len(mr) == len(mt)
    for a, b in zip(mr, mt):
        assert sorted(a) == sorted(b)
        for axis in a:
            assert b[axis].dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(a[axis]),
                                          b[axis].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_transformer_masks_from_ratios_identical(arch, dtype):
    cr, ct, pj, pt = _setup(arch, dtype)
    units = rmasks.transformer_prunable_units(cr)
    assert tmasks.transformer_prunable_units(ct) == units
    ratios = list(np.random.default_rng(1).uniform(0.1, 1.0, len(units)))
    _assert_same_masks(rmasks.transformer_masks_from_ratios(pj, cr, ratios),
                       tmasks.transformer_masks_from_ratios(pt, ct, ratios))


def test_half_ratio_keeps_half_the_groups_and_channels():
    """The chip run's masks: ratio 0.5 on every unit keeps whole GQA
    groups and half the FFN channels, as in the reference."""
    cr, ct, pj, pt = _setup("qwen2-7b", "float32", seed=2)
    n = len(rmasks.transformer_prunable_units(cr))
    mr = rmasks.transformer_masks_from_ratios(pj, cr, [0.5] * n)
    mt = tmasks.transformer_masks_from_ratios(pt, ct, [0.5] * n)
    _assert_same_masks(mr, mt)
    head = mt[0]["head_mask"].reshape(ct.num_layers, ct.num_kv_heads, -1)
    assert (head.amin(-1) == head.amax(-1)).all()      # whole groups
    assert float(mt[0]["ffn_mask"].sum()) == ct.num_layers * ct.d_ff / 2
    assert tmasks.mask_sparsity(mt) == pytest.approx(
        rmasks.mask_sparsity(mr))


def test_min_keep_matches_reference():
    cr, ct, pj, pt = _setup("qwen2-7b", "float32", seed=3)
    n = len(rmasks.transformer_prunable_units(cr))
    keep = {"head_mask": 2, "ffn_mask": 40}
    _assert_same_masks(
        rmasks.transformer_masks_from_ratios(pj, cr, [0.0] * n, keep),
        tmasks.transformer_masks_from_ratios(pt, ct, [0.0] * n, keep))


def test_cnn_masks_from_ratios_identical():
    cfg_r, cfg_t, params, _, _ = tiny_setup(seed=4)
    from repro.models.cnn import prunable_layers
    ratios = {i: r for i, r in zip(
        prunable_layers(cfg_r),
        np.random.default_rng(5).uniform(0.2, 0.9, 16))}
    mr = rmasks.cnn_masks_from_ratios(ref_tree(params), cfg_r, ratios)
    mt = tmasks.cnn_masks_from_ratios(port_params(params), cfg_t, ratios)
    assert sorted(mr) == sorted(mt)
    for i in mr:
        np.testing.assert_array_equal(np.asarray(mr[i]), mt[i].numpy())
    assert tmasks.mask_sparsity(mt) == pytest.approx(
        rmasks.mask_sparsity(mr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_head_masks_from_ratios_identical(arch, dtype):
    """The SSD head axis: one ``ssm_head_mask`` unit per Mamba2 layer,
    importance the L1 norm of each head's rows of ``w_out``; the
    hybrid's shared block has no unit."""
    cr, ct, pj, pt = _setup(arch, dtype)
    units = rmasks.transformer_prunable_units(cr)
    assert tmasks.transformer_prunable_units(ct) == units
    assert [u["axis"] for u in units] == ["ssm_head_mask"] * ct.num_layers
    ratios = list(np.random.default_rng(1).uniform(0.1, 1.0, len(units)))
    mt = tmasks.transformer_masks_from_ratios(pt, ct, ratios)
    _assert_same_masks(rmasks.transformer_masks_from_ratios(pj, cr, ratios),
                       mt)
    assert mt[0]["ssm_head_mask"].shape == (ct.num_layers, ct.ssm_heads)


def test_ssm_half_ratio_and_min_keep_match_reference():
    """The chip run's masks: ratio 0.5 keeps half the SSD heads of every
    layer; ``min_keep`` floors the count as in the reference."""
    cr, ct, pj, pt = _setup("mamba2-2.7b", "bfloat16", seed=2)
    n = len(rmasks.transformer_prunable_units(cr))
    mt = tmasks.transformer_masks_from_ratios(pt, ct, [0.5] * n)
    _assert_same_masks(
        rmasks.transformer_masks_from_ratios(pj, cr, [0.5] * n), mt)
    assert (mt[0]["ssm_head_mask"].sum(1) == ct.ssm_heads // 2).all()
    keep = {"ssm_head_mask": 5}
    _assert_same_masks(
        rmasks.transformer_masks_from_ratios(pj, cr, [0.0] * n, keep),
        tmasks.transformer_masks_from_ratios(pt, ct, [0.0] * n, keep))


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_unported_families_raise(arch):
    """The MoE family, refused here until its slice, now has the
    reference's units and masks (a head and an expert unit a layer, both
    dtypes); so, since the MLA slice, has an MoE stack with a dense first
    layer (DeepSeek-V3's ``attn_dense`` run: a head and an FFN unit for
    it, then the MoE layer's), once refused here."""
    for overrides in ({}, {"num_dense_layers": 1}):
        for dtype in ("float32", "bfloat16"):
            cr, ct, pj, pt = _setup(arch, dtype, seed=6, **overrides)
            units = rmasks.transformer_prunable_units(cr)
            assert tmasks.transformer_prunable_units(ct) == units
            ratios = list(np.random.default_rng(7).uniform(
                0.1, 1.0, len(units)))
            _assert_same_masks(
                rmasks.transformer_masks_from_ratios(pj, cr, ratios),
                tmasks.transformer_masks_from_ratios(pt, ct, ratios))
    assert [u["axis"] for u in units] == ["head_mask", "ffn_mask",
                                          "head_mask", "expert_mask"]
