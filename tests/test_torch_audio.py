"""The port's audio encoder (HuBERT: a bidirectional stack over frame
embeddings, no decode) against the reference on the same numpy inputs, at
the smoke size with the published head dim: ``hubert-xlarge``'s smoke
config (2 layers, d_model 256, a non-gated GELU FFN of 512, vocab 504)
with 4 heads of 80 (``head_dim=80``, the width the flash kernel's D = 80
instance serves; the smoke config's own 64 would not reach it). The
frame embeddings are standard normal draws (the reference stubs its conv
frontend the same way).

The reference runs with its Pallas kernels in interpret mode and with
dispatch off (``both_reference_paths``). On the CPU every wrapper of the
port runs its plain version.

Tolerances, as ``test_torch_transformer.py`` states them (``stack_tol``):
float32 logits within 64 eps of the largest logit (the same math in other
summation orders), bf16 within 4 bf16 spacings of it (bf16 rounds at other
points in XLA and PyTorch). The embedding seam is bit-equal. Attention at
D = 80 in float32: 64 eps of max|v| an output (``test_flash_attention``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core.pruning import masks as rmasks
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.models import transformer as rtr
from repro_torch.configs import registry as treg
from repro_torch.core.pruning import masks as tmasks
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from torch_parity import (EPS32, both_reference_paths, model_batch_np,
                          stack_tol, to_f32, transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

ARCH = "hubert-xlarge"
#: the smoke config at the published head dim
HEADS_80 = {"head_dim": 80, "num_heads": 4, "num_kv_heads": 4}


def _setup(dtype="float32", masked=True, seed=0, heads=HEADS_80):
    cr = rreg.get_smoke_config(ARCH).replace(dtype=dtype, **heads)
    ct = treg.get_smoke_config(ARCH).replace(dtype=dtype, **heads)
    pn = transformer_params_np(cr, seed)
    pj = jax.tree_util.tree_map(jnp.asarray, pn)
    pt = transformer_params_from_reference(pn)
    mj = mt = None
    if masked:
        n = len(rmasks.transformer_prunable_units(cr))
        ratios = list(np.random.default_rng(seed + 1).uniform(0.3, 0.8, n))
        mj = rmasks.transformer_masks_from_ratios(pj, cr, ratios)
        mt = transformer_masks_from_reference(mj)
    return cr, ct, pj, pt, mj, mt


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype, masked):
    """20 frames through the prefill step: every position's logits (an
    encoder has no cache), against both reference paths; ``forward`` gives
    the same bits."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, masked=masked)
    batch = model_batch_np(ct, 2, 20)
    lg, cache = make_prefill_step(ct, masks=mt, device="cpu")(pt, batch)
    assert cache is None
    assert lg.shape == (2, 20, ct.vocab_size)
    assert lg.dtype == getattr(torch, dtype)
    fwd = ttr.forward(pt, ct, {"embeds": torch.from_numpy(batch["embeds"])},
                      mt)[0]
    assert torch.equal(fwd, lg)
    for want in both_reference_paths(lambda: to_f32(rtr.prefill(
            pj, cr, _jax(batch), masks=mj)[0])):
        assert np.abs(to_f32(lg) - want).max() <= stack_tol(want, dtype)


def test_smoke_head_dim_matches_reference():
    """The smoke config as the registry gives it (4 heads of 64)."""
    cr, ct, pj, pt, mj, mt = _setup(heads={})
    assert ct.head_dim == 64
    batch = model_batch_np(ct, 1, 9, seed=4)
    lg, _ = make_prefill_step(ct, masks=mt, device="cpu")(pt, batch)
    for want in both_reference_paths(lambda: to_f32(rtr.prefill(
            pj, cr, _jax(batch), masks=mj)[0])):
        assert np.abs(to_f32(lg) - want).max() <= stack_tol(want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_embeddings_are_cast_to_the_model_dtype(dtype):
    """The seam: float32 frames cast to ``cfg.dtype``, bit for bit."""
    cr, ct, pj, pt, _, _ = _setup(dtype, masked=False)
    batch = model_batch_np(ct, 2, 7)
    want, B, S = rtr.embed_inputs(pj, cr, _jax(batch))
    got, Bt, St = ttr.embed_inputs(
        pt, ct, {"embeds": torch.from_numpy(batch["embeds"])})
    assert (Bt, St) == (B, S) == (2, 7)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(transformer_params_to_reference(got)
                                  .view(np.uint8),
                                  np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_at_head_dim_80_matches_reference(causal):
    """The flash wrapper at D = 80 (on the CPU its plain version), 4/2
    heads, 37 positions, against the reference's Pallas kernel in
    interpret mode, in float32: within 64 eps of max|v| an output (the
    same softmax-weighted sums in another order)."""
    assert 80 in HEAD_DIMS
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shp).astype(np.float32)
               for shp in ((2, 37, 4, 80), (2, 37, 2, 80), (2, 37, 2, 80)))
    want = to_f32(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, interpret=True))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    assert got.shape == want.shape
    assert np.abs(to_f32(got) - want).max() <= 64 * EPS32 * np.abs(v).max()


def test_decode_step_is_refused(monkeypatch):
    """An encoder has no decode step (the reference's shape table skips
    decode for it): ``make_decode_step`` says so, on the CPU and on the
    card path (``torch.cuda.is_available`` patched true: building a step
    touches no device), for the smoke and the published config."""
    for cfg in (_setup(masked=False)[1], treg.get_config(ARCH)):
        with pytest.raises(ValueError, match="no decode step"):
            make_decode_step(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no decode step"):
        make_decode_step(treg.get_config(ARCH))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_masks_cross_interop_both_ways(dtype):
    """Parameters to the reference and back bit for bit; masks from the
    reference equal, and the port's masks, handed to the reference, give
    its logits exactly as its own masks do."""
    cr, ct, pj, pt, mj, mt = _setup(dtype)
    back = transformer_params_to_reference(pt)
    flat_r, tree_r = jax.tree_util.tree_flatten(pj)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_b
    for a, b in zip(flat_r, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    n = len(tmasks.transformer_prunable_units(ct))
    mine = tmasks.transformer_masks_from_ratios(pt, ct, [0.5] * n)
    theirs = rmasks.transformer_masks_from_ratios(pj, cr, [0.5] * n)
    handed = jax.tree_util.tree_map(jnp.asarray,
                                    transformer_params_to_reference(mine))
    batch = _jax(model_batch_np(ct, 1, 6))
    np.testing.assert_array_equal(
        to_f32(rtr.forward(pj, cr, batch, handed)[0]),
        to_f32(rtr.forward(pj, cr, batch, theirs)[0]))
    for a, b in zip(mj, mt):
        for axis in a:
            np.testing.assert_array_equal(np.asarray(a[axis]),
                                          b[axis].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_units_and_masks_equal_reference(dtype):
    """A head and an FFN unit a layer (the FFN has no gate: its unit is
    ``w_up``'s column); the kept heads and channels at random ratios and
    at the chip run's 0.5 equal the reference's."""
    cr, ct, pj, pt, _, _ = _setup(dtype, masked=False, seed=6)
    units = rmasks.transformer_prunable_units(cr)
    assert tmasks.transformer_prunable_units(ct) == units
    assert [u["axis"] for u in units] == ["head_mask", "ffn_mask"] * 2
    for ratios in (list(np.random.default_rng(7).uniform(0.1, 1.0,
                                                         len(units))),
                   [0.5] * len(units)):
        want = rmasks.transformer_masks_from_ratios(pj, cr, ratios)
        got = tmasks.transformer_masks_from_ratios(pt, ct, ratios)
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert sorted(a) == sorted(b)
            for axis in a:
                assert b[axis].dtype == torch.float32
                np.testing.assert_array_equal(np.asarray(a[axis]),
                                              b[axis].numpy())
