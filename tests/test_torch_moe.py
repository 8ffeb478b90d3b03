"""The port's mixture-of-experts path (``repro_torch.models.layers.moe``,
the MoE blocks of ``repro_torch.models.transformer``, the expert axis of
``repro_torch.core.pruning.masks``) against the reference on the same
numpy inputs, at the smoke size: Mixtral's smoke config (2 layers,
d_model 256, 4/2 heads of 64, 4 experts of d_expert 256, top-2, capacity
factor 1.25, window 64, vocab 512), and a lone MoE layer (d_model 128, 4
experts of 96) under every routing option the reference has — softmax and
sigmoid scores, 0 and 1 shared experts, with and without an expert mask,
and a capacity factor of 0.25 that drops assignments.

The reference runs with its Pallas kernels in interpret mode
(``dispatch.use_pallas(interpret=True)``: rmsnorm and flash attention; its
MoE dispatch has no kernel) and with dispatch off. On the CPU every
wrapper of the port runs its plain version.

Tolerances, as ``test_torch_transformer.py`` states them: float32 within
64 eps of the largest entry (the same math in other summation orders);
bf16 within 4 bf16 spacings (2**-5) of the largest entry. Routes (the
experts each token picks) and ``drop_frac`` must be equal exactly: a layer
given the same input picks the same experts, since no two of its scores
tie (``moe.route``'s docstring says where a tie could arise). Through the
bf16 stack a logit row may also differ by twice the reference's own two
paths' gap on that row (``assert_rows_close``: a route flip).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.configs.base import MoEConfig as RMoEConfig
from repro.core.pruning import masks as rmasks
from repro.models import transformer as rtr
from repro.models.layers import moe as rmoe
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.pruning import masks as tmasks
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.kernels.flash_attention.ops import check_head_dim
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import moe as tmoe
from torch_parity import (assert_rows_close, both_reference_paths,
                          stack_tol, to_f32, transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

ARCH = "mixtral-8x7b"
#: the lone layer's routing options: MoEConfig overrides
LAYER_VARIANTS = {
    "softmax": {},
    "sigmoid": {"score_fn": "sigmoid"},
    "shared": {"num_shared": 1},
    "sigmoid_shared": {"score_fn": "sigmoid", "num_shared": 1},
    "dropping": {"capacity_factor": 0.25},
}
D_LAYER, E_LAYER, DE_LAYER = 128, 4, 96


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------
def _moe_cfgs(variant):
    kw = {"num_experts": E_LAYER, "top_k": 2, "d_expert": DE_LAYER,
          "capacity_factor": 1.25, **LAYER_VARIANTS[variant]}
    return RMoEConfig(**kw), TMoEConfig(**kw)


def _layer_setup(variant, dtype, masked, seed=0, B=2, S=24):
    """(moe_r, moe_t, params_j, params_t, x_j, x_t, mask_j, mask_t): the
    reference's parameter tree for the layer filled from numpy (weights
    normal / sqrt(fan_in), the router in float32), an input of unit
    scale, and a mask that keeps 3 of the 4 experts."""
    mr, mt = _moe_cfgs(variant)
    shapes = jax.eval_shape(lambda: rmoe.init_moe_params(
        jax.random.PRNGKey(0), D_LAYER, mr, "silu_glu", jnp.dtype(dtype)))
    rng = np.random.default_rng(seed)
    pn = {name: (rng.standard_normal(sd.shape) / np.sqrt(sd.shape[-2]))
          .astype(np.float32).astype(sd.dtype)
          for name, sd in shapes.items()}
    x = rng.standard_normal((B, S, D_LAYER)).astype(np.float32).astype(
        jnp.dtype(dtype))
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    return (mr, mt, jax.tree_util.tree_map(jnp.asarray, pn),
            transformer_params_from_reference(pn), jnp.asarray(x),
            transformer_params_from_reference(x),
            None if mask is None else jnp.asarray(mask),
            None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 25, 64, 80, 160, 1000,
                                    2048, 8192])
@pytest.mark.parametrize("variant", sorted(LAYER_VARIANTS))
def test_capacity_matches_reference(variant, tokens):
    mr, mt = _moe_cfgs(variant)
    assert tmoe.capacity(tokens, mt) == rmoe.capacity(tokens, mr)
    full = treg.get_config(ARCH).moe
    assert tmoe.capacity(tokens, full) == rmoe.capacity(
        tokens, rreg.get_config(ARCH).moe)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(LAYER_VARIANTS))
def test_route_matches_reference(variant, dtype, masked):
    mr, mt, pj, pt, xj, xt, mj, mk = _layer_setup(variant, dtype, masked)
    want = rmoe.route(pj, mr, xj.reshape(-1, D_LAYER), mj)
    got = tmoe.route(pt, mt, xt.reshape(-1, D_LAYER), mk)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if mj is not None:
        assert not (got[1] == 1).any()          # the pruned expert
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert g.dtype == torch.float32
        w = to_f32(w)
        assert np.abs(to_f32(g) - w).max() <= stack_tol(w, "float32")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(LAYER_VARIANTS))
def test_moe_forward_matches_reference(variant, dtype, masked):
    """The layer's output and its metrics; ``drop_frac`` equal exactly,
    above 0 at capacity factor 0.25."""
    mr, mt, pj, pt, xj, xt, mj, mk = _layer_setup(variant, dtype, masked)
    want, wm = rmoe.moe_forward(pj, mr, xj, "silu_glu", expert_mask=mj)
    got, gm = tmoe.moe_forward(pt, mt, xt, "silu_glu", expert_mask=mk)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    want = to_f32(want)
    assert np.abs(to_f32(got) - want).max() <= stack_tol(want, dtype)
    for g, w in ((gm.aux_loss, wm.aux_loss), (gm.z_loss, wm.z_loss)):
        assert abs(float(g) - float(w)) <= stack_tol(np.asarray(w), "float32")
    assert float(gm.drop_frac) == float(wm.drop_frac)
    if variant == "dropping":
        assert float(gm.drop_frac) > 0.5


def test_dropped_assignments_follow_token_order():
    """Past capacity the later tokens' assignments drop (the sort is
    stable): with every token routed to the same two experts and C = 16,
    tokens 16.. get nothing from the routed experts."""
    mr, mt, pj, pt, xj, xt, _, _ = _layer_setup("softmax", "float32", False,
                                                B=1, S=20)
    x = torch.ones_like(xt)
    out, metrics = tmoe.moe_forward(pt, mt, x, "silu_glu")
    assert tmoe.capacity(20, mt) == 16
    want, wm = rmoe.moe_forward(pj, mr, jnp.ones_like(xj), "silu_glu")
    assert float(metrics.drop_frac) == float(wm.drop_frac)
    assert float(metrics.drop_frac) == pytest.approx(1 - 32 / 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=0, atol=stack_tol(np.asarray(want),
                                                 "float32"))
    assert (out[0, 16:] == 0).all() and (out[0, :16] != 0).any()


# ---------------------------------------------------------------------------
# the Mixtral stack at the smoke size
# ---------------------------------------------------------------------------
def _setup(dtype="float32", seed=0, masked=True, **overrides):
    cr = rreg.get_smoke_config(ARCH).replace(dtype=dtype, **overrides)
    ct = treg.get_smoke_config(ARCH).replace(dtype=dtype, **overrides)
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


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_forward_matches_reference(dtype, masked):
    """80 tokens, past the window of 64; the router losses summed over
    the layers as the reference's scan carries them."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, masked=masked)
    tok = _tokens(cr, 2, 80)
    got, aux = ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)
    assert got.shape == (2, 80, ct.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    refs = both_reference_paths(lambda: rtr.forward(
        pj, cr, {"tokens": jnp.asarray(tok)}, mj))
    assert_rows_close(to_f32(got), *(to_f32(lg) for lg, _ in refs), dtype)
    for _, raux in refs:
        for key in ("moe_aux", "moe_z"):
            assert aux[key].dtype == torch.float32
            w = to_f32(raux[key])
            assert float(w) > 0
            assert abs(float(aux[key]) - float(w)) <= stack_tol(w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_prefill_then_decode_matches_reference(dtype):
    """Prefill 76 tokens (past the window: the cache is the rolled
    64-slot buffer), then 4 decode steps through the steps a server calls,
    against the reference's prefill and decode_step; the rolled keys equal
    the reference's. Each logit row also equals the port's own forward
    (cache consistency) at a capacity factor of E / top_k, where no call
    drops an assignment: at 1.25 what a call drops depends on how many
    tokens it dispatches (80 in the forward, 76 in the prefill, 2 a decode
    step), in the reference as in the port."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, seed=1)
    B, S, n_dec = 2, 80, 4
    tok = _tokens(cr, B, S, seed=3)
    snaps = []

    def reference():
        lg, cache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(
            tok[:, :S - n_dec])}, max_len=S, masks=mj)
        snaps.append(to_f32(cache["runs"][0].k))
        outs = [to_f32(lg)]
        for t in range(S - n_dec, S):
            lg, cache = rtr.decode_step(pj, cr, cache,
                                        jnp.asarray(tok[:, t:t + 1]), mj)
            outs.append(to_f32(lg))
        return np.stack(outs, 1)

    prefill = make_prefill_step(ct, max_len=S, masks=mt, device="cpu")
    decode = make_decode_step(ct, masks=mt, device="cpu")
    lg, cache = prefill(pt, {"tokens": tok[:, :S - n_dec]})
    k_prefill = to_f32(cache["runs"][0].k).copy()
    assert k_prefill.shape == (ct.num_layers, B, ct.sliding_window,
                               ct.num_kv_heads, ct.head_dim)
    outs = [to_f32(lg)]
    for t in range(S - n_dec, S):
        lg, cache = decode(pt, cache, tok[:, t:t + 1])
        outs.append(to_f32(lg))
    got = np.stack(outs, 1)
    assert cache["pos"].tolist() == [S] * B
    assert_rows_close(got, *both_reference_paths(reference), dtype)
    for snap in snaps:
        assert np.abs(k_prefill - snap).max() <= stack_tol(snap, dtype)

    roomy = ct.replace(moe=dataclasses.replace(
        ct.moe, capacity_factor=ct.moe.num_experts / ct.moe.top_k))
    lg, cache = ttr.prefill(pt, roomy, {"tokens": torch.from_numpy(
        tok[:, :S - n_dec])}, max_len=S, masks=mt)
    outs = [to_f32(lg)]
    for t in range(S - n_dec, S):
        lg, cache = ttr.decode_step(pt, roomy, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), mt)
        outs.append(to_f32(lg))
    full = to_f32(ttr.forward(pt, roomy, {"tokens": torch.from_numpy(tok)},
                              mt)[0])[:, S - n_dec - 1:]
    assert np.abs(np.stack(outs, 1) - full).max() <= stack_tol(full, dtype)


def test_mixtral_masks_from_ratios_match_reference():
    """The expert axis: one ``expert_mask`` unit beside each layer's head
    unit, importance |w_down| summed per expert, at least top_k +
    num_shared experts kept unless ``min_keep`` says otherwise; ratio 0.5
    keeps half the experts and half the KV groups (the card's masks)."""
    cr, ct, pj, pt, _, _ = _setup("bfloat16", seed=4, masked=False)
    units = rmasks.transformer_prunable_units(cr)
    assert tmasks.transformer_prunable_units(ct) == units
    assert [u["axis"] for u in units] == ["head_mask", "expert_mask"] * 2
    n = len(units)
    for ratios, keep in ((list(np.random.default_rng(5).uniform(
            0.1, 1.0, n)), None), ([0.5] * n, None), ([0.0] * n, None),
            ([0.0] * n, {"expert_mask": 3, "head_mask": 2})):
        mr = rmasks.transformer_masks_from_ratios(pj, cr, ratios, keep)
        mt = tmasks.transformer_masks_from_ratios(pt, ct, ratios, keep)
        assert len(mr) == len(mt) == 1 and sorted(mr[0]) == sorted(mt[0])
        for axis in mr[0]:
            assert mt[0][axis].dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(mr[0][axis]),
                                          mt[0][axis].numpy())
    floor = tmasks.transformer_masks_from_ratios(pt, ct, [0.0] * n)
    assert (floor[0]["expert_mask"].sum(1) == ct.moe.top_k).all()
    half = tmasks.transformer_masks_from_ratios(pt, ct, [0.5] * n)
    assert (half[0]["expert_mask"].sum(1) == ct.moe.num_experts // 2).all()


def test_mixtral_trees_cross_interop_both_ways():
    """The MoE parameter tree (the float32 router; stacked (count, E, ...)
    bf16 experts as a uint16 view) and the expert masks cross bit for
    bit, and ``init_params`` draws the reference's layout."""
    cr, ct, pj, pt, mj, mt = _setup("bfloat16")
    moe = pt["runs"][0]["moe"]
    assert moe["w_router"].dtype == torch.float32
    assert moe["w_up"].dtype == torch.bfloat16
    assert moe["w_up"].shape == (ct.num_layers, ct.moe.num_experts,
                                 ct.d_model, ct.moe.d_expert)
    back = transformer_params_to_reference(pt)
    flat_r, tree_r = jax.tree_util.tree_flatten(pj)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_b
    for a, b in zip(flat_r, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert mt[0]["expert_mask"].shape == (ct.num_layers, ct.moe.num_experts)
    for axis in mj[0]:
        np.testing.assert_array_equal(mt[0][axis].numpy(),
                                      np.asarray(mj[0][axis]))
    ref = jax.eval_shape(lambda: rtr.init_params(cr, jax.random.PRNGKey(0)))
    got = ttr.init_params(ct, seed=0, device="cpu")
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_r == tree_g
    for r, g in zip(flat_r, flat_g):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(r.dtype) == str(g.dtype).removeprefix("torch.")


def test_mixtral_full_config_is_served_and_the_rest_refused():
    """``make_prefill_step`` takes the full Mixtral config (its head dim
    128 has a flash kernel instance) and a smoke MoE config with a dense
    first layer (DeepSeek-V3's ``attn_dense`` run, served since the MLA
    slice); an MoE config with audio frames for input, once refused here,
    is served since the audio slice: its prefill over 12 frame embeddings
    and a decode step match both reference paths (``assert_rows_close``)."""
    cfg = treg.get_config(ARCH)
    check_head_dim(cfg.head_dim)
    assert callable(make_prefill_step(cfg, device="cpu"))
    assert callable(make_decode_step(cfg, device="cpu"))
    dense_first = treg.get_smoke_config(ARCH).replace(num_dense_layers=1)
    assert callable(make_prefill_step(dense_first, device="cpu"))
    cr, ct, pj, pt, mj, mt = _setup(embeds_input=True)
    frames = np.random.default_rng(8).standard_normal(
        (2, 12, ct.d_model)).astype(np.float32)
    tok = _tokens(cr, 2, 1, seed=9)
    lg, cache = make_prefill_step(ct, max_len=13, masks=mt, device="cpu")(
        pt, {"embeds": frames})
    lg2, _ = make_decode_step(ct, masks=mt, device="cpu")(pt, cache, tok)

    def reference():
        rlg, rcache = rtr.prefill(pj, cr, {"embeds": jnp.asarray(frames)},
                                  max_len=13, masks=mj)
        rlg2, _ = rtr.decode_step(pj, cr, rcache, jnp.asarray(tok), mj)
        return np.stack([to_f32(rlg), to_f32(rlg2)], 1)
    assert_rows_close(np.stack([to_f32(lg), to_f32(lg2)], 1),
                      *both_reference_paths(reference), "float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        rreg.get_config(ARCH))
