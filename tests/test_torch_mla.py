"""The port's MLA path (``repro_torch.models.layers.attention``:
``chunked_attention``, ``naive_attention`` on unequal head dims,
``mla_forward``, ``mla_decode``), the DeepSeek-V3 stack of
``repro_torch.models.transformer`` (a dense ``attn_dense`` run, then MoE
layers, MLA attention, the ``mtp`` subtree) and MLA's head axis of
``repro_torch.core.pruning.masks``, against the reference on the same
numpy inputs, at the smoke size: DeepSeek-V3's smoke config (2 layers, 1
dense + 1 MoE, d_model 256, 4 heads, MLA ranks 128/64, nope/rope/v head
dims 32/16/32, d_ff 512, 4 experts of 256, top-2, sigmoid scores, 1
shared expert, capacity factor 1.0, vocab 512, MTP depth 1).

The reference runs with its Pallas kernels in interpret mode
(``dispatch.use_pallas(interpret=True)``: rmsnorm and the masked FFN
GEMMs; its MLA attention has no kernel) and with dispatch off. On the CPU
every wrapper of the port runs its plain version.

Tolerances, as ``test_torch_transformer.py`` states them
(``torch_parity.stack_tol``): float32 within 64 eps of the largest entry,
bf16 within 4 bf16 spacings of it; routes and ``drop_frac`` exactly; a
bf16 logit row of the stack may also differ by twice the reference's own
two paths' gap on that row (``torch_parity.assert_rows_close``: a route
flip).
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core.pruning import masks as rmasks
from repro.models import transformer as rtr
from repro.models.layers import attention as ratt
from repro.models.layers import moe as rmoe
from repro_torch.configs import registry as treg
from repro_torch.core.pruning import masks as tmasks
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import attention as tatt
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.layers.rope import rope_angles
from torch_parity import (assert_rows_close, both_reference_paths, stack_tol,
                          to_f32, transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

ARCH = "deepseek-v3-671b"
DTYPES = ["float32", "bfloat16"]


def _pair(x_np):
    """One numpy array as the reference's JAX array and the port's
    tensor (bf16 bit for bit)."""
    return jnp.asarray(x_np), transformer_params_from_reference(x_np)


def _close(got, want, dtype):
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= stack_tol(want, dtype)


# ---------------------------------------------------------------------------
# chunked and naive attention
# ---------------------------------------------------------------------------
#: (causal, window): the chunked path's masks
CHUNKED = {"causal": (True, None), "noncausal": (False, None),
           "window": (True, 5), "window_noncausal": (False, 6)}


def _qkv(dtype, B=2, S=21, H=4, Hkv=2, D=24, Dv=16, seed=0):
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32).astype(dt)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32).astype(dt)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32).astype(dt)
    return q, k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", sorted(CHUNKED))
def test_chunked_attention_matches_reference(variant, dtype):
    """21 keys in blocks of 8: two whole blocks and one padded by 3
    (sentinel positions); GQA groups of 2, qk head dim 24, v head dim 16.
    Equal to the reference's ``chunked_attention`` and, in float32, to the
    port's own naive attention on the same mask."""
    causal, window = CHUNKED[variant]
    q, k, v = _qkv(dtype)
    B, S = q.shape[:2]
    scale = 24 ** -0.5
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = ratt.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  jnp.asarray(pos), jnp.asarray(pos), causal,
                                  window, scale, block_kv=8)
    tq, tk, tv = (transformer_params_from_reference(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    got = tatt.chunked_attention(tq, tk, tv, tpos, tpos, causal, window,
                                 scale, block_kv=8)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, S, 4, 16)
    _close(got, want, dtype)
    if dtype == "float32":
        mask = tatt._band_mask(torch.arange(S), torch.arange(S), causal,
                               window)
        _close(got, tatt.naive_attention(tq, tk, tv, mask, scale), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention_on_unequal_head_dims(causal, dtype):
    """MLA's naive path: qk head dim 48 (nope 32 + rope 16), v head dim
    32, every head its own KV head."""
    q, k, v = _qkv(dtype, S=13, H=4, Hkv=4, D=48, Dv=32, seed=1)
    S = q.shape[1]
    mask_j = ratt._band_mask(jnp.arange(S), jnp.arange(S), causal, None)
    want = ratt.naive_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                mask_j, 48 ** -0.5)
    mask_t = tatt._band_mask(torch.arange(S), torch.arange(S), causal, None)
    got = tatt.naive_attention(*(transformer_params_from_reference(a)
                                 for a in (q, k, v)), mask_t, 48 ** -0.5)
    assert tuple(got.shape) == (2, S, 4, 32)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# one MLA layer
# ---------------------------------------------------------------------------
def _layer_setup(dtype, masked, B=2, S=11, seed=0):
    """(cfg_r, cfg_t, params (ref, port), x (ref, port), angles (ref,
    port), head mask (ref, port) or Nones): the MLA layer's tree filled
    from numpy (weights normal / sqrt(fan_in), norm scales near 1), an
    input of unit scale, the rotary angles of positions 0..S-1 over the
    rope head dim, and a mask that keeps heads 0, 2 and 3."""
    cr = rreg.get_smoke_config(ARCH).replace(dtype=dtype)
    ct = treg.get_smoke_config(ARCH).replace(dtype=dtype)
    dt = jnp.dtype(dtype)
    shapes = jax.eval_shape(lambda: ratt.init_mla_params(
        jax.random.PRNGKey(0), cr, dt))
    rng = np.random.default_rng(seed)
    pn = {}
    for name, sd in sorted(shapes.items()):
        if name.endswith("norm"):
            a = 1.0 + 0.1 * rng.standard_normal(sd.shape)
        else:
            a = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[0])
        pn[name] = a.astype(np.float32).astype(sd.dtype)
    x = rng.standard_normal((B, S, cr.d_model)).astype(np.float32).astype(dt)
    ang = rope_angles(torch.arange(S)[None].expand(B, S),
                      ct.mla.qk_rope_head_dim, ct.rope_theta).numpy()
    hm = np.array([1, 0, 1, 1], np.float32) if masked else None
    return (cr, ct, (jax.tree_util.tree_map(jnp.asarray, pn),
                     transformer_params_from_reference(pn)),
            _pair(x), _pair(ang),
            (None, None) if hm is None else _pair(hm))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_forward_matches_reference(dtype, masked):
    """The output, the latent and the shared rotary key the cache keeps,
    against both reference paths; a pruned head contributes nothing."""
    cr, ct, (pj, pt), (xj, xt), (aj, at), (mj, mt) = _layer_setup(dtype,
                                                                 masked)
    got, (ckv, krope) = tatt.mla_forward(pt, ct, xt, at, head_mask=mt)
    assert got.dtype == xt.dtype
    assert tuple(ckv.shape) == (2, 11, ct.mla.kv_lora_rank)
    assert tuple(krope.shape) == (2, 11, ct.mla.qk_rope_head_dim)
    for out, (rckv, rkrope) in both_reference_paths(
            lambda: ratt.mla_forward(pj, cr, xj, aj, head_mask=mj)):
        _close(got, out, dtype)
        _close(ckv, rckv, dtype)
        _close(krope, rkrope, dtype)
    if masked:
        alone = dict(pt, wo=pt["wo"].clone())
        vd = ct.mla.v_head_dim
        alone["wo"][vd:2 * vd] = 7.0           # head 1's rows of wo
        again, _ = tatt.mla_forward(alone, ct, xt, at, head_mask=mt)
        assert torch.equal(again, got)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_reference(dtype, masked):
    """One absorbed decode step of two sequences at positions 5 and 9 of
    a 12-slot latent cache filled with random earlier entries (slots past
    each position hold values that the valid mask must hide): the output
    and the cache written in place at ``pos``, against both reference
    paths."""
    cr, ct, (pj, pt), _, _, (mj, mt) = _layer_setup(dtype, masked)
    rng = np.random.default_rng(3)
    dt = jnp.dtype(dtype)
    x = rng.standard_normal((2, 1, cr.d_model)).astype(np.float32).astype(dt)
    pos = np.array([5, 9], np.int32)
    ckv = rng.standard_normal((2, 12, cr.mla.kv_lora_rank)).astype(
        np.float32).astype(dt)
    kr = rng.standard_normal((2, 12, cr.mla.qk_rope_head_dim)).astype(
        np.float32).astype(dt)
    ang = rope_angles(torch.from_numpy(pos)[:, None],
                      ct.mla.qk_rope_head_dim, ct.rope_theta).numpy()
    cache = tatt.MLACache(*(transformer_params_from_reference(a)
                            for a in (ckv, kr)))
    got, out_cache = tatt.mla_decode(
        pt, ct, transformer_params_from_reference(x),
        torch.from_numpy(ang), cache, torch.from_numpy(pos), head_mask=mt)
    assert out_cache.ckv is cache.ckv           # written in place
    for out, rcache in both_reference_paths(lambda: ratt.mla_decode(
            pj, cr, jnp.asarray(x), jnp.asarray(ang),
            ratt.MLACache(jnp.asarray(ckv), jnp.asarray(kr)),
            jnp.asarray(pos), head_mask=mj)):
        _close(got, out, dtype)
        _close(cache.ckv, rcache.ckv, dtype)
        _close(cache.krope, rcache.krope, dtype)
    untouched = np.ones((2, 12), bool)
    untouched[0, 5] = untouched[1, 9] = False
    np.testing.assert_array_equal(to_f32(cache.ckv)[untouched],
                                  to_f32(ckv)[untouched])


# ---------------------------------------------------------------------------
# the DeepSeek-V3 stack at the smoke size
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


#: the stack's attention path: naive (the default ``naive_attn_max`` of
#: 4096) or chunked (``naive_attn_max`` below the 20 tokens)
PATHS = {"naive": {}, "chunked": {"naive_attn_max": 8}}


@contextlib.contextmanager
def _moe_calls(module):
    """Record each MoE layer call of ``module``'s stack (the reference's
    or the port's ``transformer``) made while the block runs: a list of
    (the layer's parameters, its input, its expert mask). Run the
    reference under ``jax.disable_jit()``, so that its scan hands the
    layer concrete arrays."""
    calls, inner = [], module.moe_forward

    def watched(params, moe, x, activation, *, expert_mask=None):
        calls.append((params, x, expert_mask))
        return inner(params, moe, x, activation, expert_mask=expert_mask)
    module.moe_forward = watched
    try:
        yield calls
    finally:
        module.moe_forward = inner


def _routed_apart(cr, ct, pj, pt, mj, mt, tok):
    """(B, S) flags of the tokens that the port's forward and the
    reference's (its XLA path) send to different experts in some MoE
    layer. Each layer is first held to pick, on the port's own input, the
    port's experts exactly: the two layers agree given one input, and only
    a rounding upstream moved a token across the top-k boundary."""
    B, S = tok.shape
    with _moe_calls(ttr) as tcalls:
        ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)
    with _moe_calls(rtr) as rcalls, jax.disable_jit():
        rtr.forward(pj, cr, {"tokens": jnp.asarray(tok)}, mj)
    assert len(tcalls) == len(rcalls) == 1
    apart = np.zeros(B * S, bool)
    for (lt, xt, et), (lr, xr, er) in zip(tcalls, rcalls):
        got = tmoe.route(lt, ct.moe, xt.reshape(B * S, -1), et)[1].numpy()
        x_port = jnp.asarray(transformer_params_to_reference(xt))
        np.testing.assert_array_equal(np.asarray(rmoe.route(
            lr, cr.moe, x_port.reshape(B * S, -1), er)[1]), got)
        want = rmoe.route(lr, cr.moe, xr.reshape(B * S, -1), er)[1]
        apart |= (got != np.asarray(want)).any(-1)
    return apart.reshape(B, S)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_forward_matches_reference(dtype, path, masked):
    """20 tokens through the dense layer and the MoE layer; the MoE
    layer's router losses as the reference's scan carries them. A token
    the port routes to other experts than the reference does
    (``_routed_apart``: a near tie of two sigmoid scores that one bf16
    rounding of the layer's input tips) is held only to that; it may be
    at most 2 of the 40. With the smoke weights one token is, in bf16
    with the masks: experts 1 and 3 score logits of -1.5022 and -1.4992,
    and the port's input picks 3 where the reference's picks 1. Its row
    is the only one past the tolerance (0.51, where the others are within
    0.047); the MoE layer is the stack's last, so the flip touches no
    other row."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, masked=masked, **PATHS[path])
    tok = _tokens(cr, 2, 20)
    got, aux = ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)
    assert got.shape == (2, 20, ct.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    refs = both_reference_paths(lambda: rtr.forward(
        pj, cr, {"tokens": jnp.asarray(tok)}, mj))
    held = ~_routed_apart(cr, ct, pj, pt, mj, mt, tok)
    assert held.sum() >= held.size - 2
    assert_rows_close(to_f32(got)[held],
                      *(to_f32(lg)[held] for lg, _ in refs), dtype)
    for _, raux in refs:
        for key in ("moe_aux", "moe_z"):
            w = to_f32(raux[key])
            assert float(w) > 0
            assert abs(float(aux[key]) - float(w)) <= stack_tol(w, dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_deepseek_routes_and_drops_match_reference(masked):
    """The MoE layer given the reference's own input to it (the dense
    layer's output): its routes and ``drop_frac`` (capacity factor 1.0: 40
    tokens x top-2 over 4 experts, C = 24 slots, filled unevenly, so some
    assignments drop) equal the reference's exactly, with and without the
    expert mask; its output within the float32 tolerance."""
    cr, ct, pj, pt, mj, mt = _setup("float32", seed=5)
    tok = _tokens(cr, 2, 20, seed=6)
    with _moe_calls(rtr) as rcalls, jax.disable_jit():
        rtr.forward(pj, cr, {"tokens": jnp.asarray(tok)}, mj)
    lj, xj, em_j = rcalls[0]
    lt = {k: v[0] for k, v in pt["runs"][1]["moe"].items()}
    xt = transformer_params_from_reference(xj)
    em_t = mt[1]["expert_mask"][0]
    if not masked:
        em_j = em_t = None
    want_idx = rmoe.route(lj, cr.moe, xj.reshape(40, -1), em_j)[1]
    got_idx = tmoe.route(lt, ct.moe, xt.reshape(40, -1), em_t)[1]
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    want, wm = rmoe.moe_forward(lj, cr.moe, xj, "silu_glu",
                                expert_mask=em_j)
    got, gm = tmoe.moe_forward(lt, ct.moe, xt, "silu_glu",
                               expert_mask=em_t)
    assert float(gm.drop_frac) == float(wm.drop_frac) > 0
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_prefill_then_decode_matches_reference(dtype):
    """Prefill 16 tokens into a 20-slot ``MLACache``, then 4 decode steps
    through the steps a server calls, against the reference's prefill and
    decode_step; the latent and rotary-key caches equal the reference's
    after prefill and after decode. Each logit row also equals the port's
    own forward (cache consistency) at a capacity factor of E / top_k,
    where no call drops an assignment."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, seed=1)
    B, S, n_dec = 2, 20, 4
    tok = _tokens(cr, B, S, seed=3)
    snaps = []

    def reference():
        lg, cache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(
            tok[:, :S - n_dec])}, max_len=S, masks=mj)
        snaps.append([(to_f32(c.ckv), to_f32(c.krope))
                      for c in cache["runs"]])
        outs = [to_f32(lg)]
        for t in range(S - n_dec, S):
            lg, cache = rtr.decode_step(pj, cr, cache,
                                        jnp.asarray(tok[:, t:t + 1]), mj)
            outs.append(to_f32(lg))
        snaps.append([(to_f32(c.ckv), to_f32(c.krope))
                      for c in cache["runs"]])
        return np.stack(outs, 1)

    prefill = make_prefill_step(ct, max_len=S, masks=mt, device="cpu")
    decode = make_decode_step(ct, masks=mt, device="cpu")
    lg, cache = prefill(pt, {"tokens": tok[:, :S - n_dec]})
    assert [type(c) for c in cache["runs"]] == [tatt.MLACache] * 2
    assert tuple(cache["runs"][1].ckv.shape) == (1, B, S,
                                                 ct.mla.kv_lora_rank)
    got_snaps = [[(to_f32(c.ckv).copy(), to_f32(c.krope).copy())
                  for c in cache["runs"]]]
    outs = [to_f32(lg)]
    for t in range(S - n_dec, S):
        lg, cache = decode(pt, cache, tok[:, t:t + 1])
        outs.append(to_f32(lg))
    got_snaps.append([(to_f32(c.ckv), to_f32(c.krope))
                      for c in cache["runs"]])
    got = np.stack(outs, 1)
    assert cache["pos"].tolist() == [S] * B
    assert_rows_close(got, *both_reference_paths(reference), dtype)
    for i, want in enumerate(snaps):
        for (g_ckv, g_kr), (w_ckv, w_kr) in zip(got_snaps[i % 2], want):
            assert np.abs(g_ckv - w_ckv).max() <= stack_tol(w_ckv, dtype)
            assert np.abs(g_kr - w_kr).max() <= stack_tol(w_kr, dtype)

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


def test_deepseek_init_params_has_the_reference_layout_with_mtp():
    """``init_params``: the reference's tree, shapes and dtypes, the
    ``mtp`` subtree included (its projection of [hidden; next embedding],
    a GQA block — the reference builds MTP's block with GQA attention in
    an MLA config — and its norm); ``init_cache`` the layout ``prefill``
    fills; the ``attn_dense`` run's MLA blocks beside a dense FFN."""
    cr, ct = (reg.get_smoke_config(ARCH) for reg in (rreg, treg))
    ref = jax.eval_shape(lambda: rtr.init_params(cr, jax.random.PRNGKey(0)))
    got = ttr.init_params(ct, seed=0, device="cpu")
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_r == tree_g
    for r, g in zip(flat_r, flat_g):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(r.dtype) == str(g.dtype).removeprefix("torch.")
    assert ttr.param_count(got) == sum(x.size for x in flat_r)
    mtp = got["mtp"]
    assert sorted(mtp) == ["block", "ln", "proj"]
    assert sorted(mtp["block"]["attn"]) == ["wk", "wo", "wq", "wv"]
    assert tuple(mtp["proj"].shape) == (2 * ct.d_model, ct.d_model)
    assert sorted(got["runs"][0]) == ["attn", "ln1", "ln2", "mlp"]
    assert "w_uv" in got["runs"][0]["attn"] and "moe" in got["runs"][1]
    cache = ttr.init_cache(ct, 2, 12, device="cpu")
    _, filled = ttr.prefill(got, ct, {"tokens": torch.zeros(
        (2, 5), dtype=torch.long)}, max_len=12)
    flat_c, tree_c = jax.tree_util.tree_flatten(cache)
    flat_f, tree_f = jax.tree_util.tree_flatten(filled)
    assert tree_c == tree_f
    for c, f in zip(flat_c, flat_f):
        assert c.shape == f.shape and c.dtype == f.dtype


def test_deepseek_trees_and_caches_cross_interop_both_ways():
    """The bf16 parameter tree (the ``mtp`` subtree included) and the MLA
    masks cross bit for bit; a prefill cache crosses both ways as
    ``MLACache``s and bit for bit, and each package decodes the next token
    from the other's cache as from its own."""
    cr, ct, pj, pt, mj, mt = _setup("bfloat16")
    back = transformer_params_to_reference(pt)
    flat_r, tree_r = jax.tree_util.tree_flatten(pj)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_b
    for a, b in zip(flat_r, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for run_j, run_t in zip(mj, mt):
        assert sorted(run_j) == sorted(run_t)
        for axis in run_j:
            np.testing.assert_array_equal(run_t[axis].numpy(),
                                          np.asarray(run_j[axis]))
    tok = _tokens(cr, 2, 9, seed=4)
    _, rcache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(tok[:, :8])},
                            max_len=10, masks=mj)
    _, tcache = ttr.prefill(pt, ct, {"tokens": torch.from_numpy(
        tok[:, :8])}, max_len=10, masks=mt)
    from_ref = transformer_params_from_reference(rcache)
    to_ref = transformer_params_to_reference(tcache)
    assert [type(c) for c in from_ref["runs"]] == [tatt.MLACache] * 2
    for c_r, c_f, c_t, c_b in zip(rcache["runs"], from_ref["runs"],
                                  tcache["runs"], to_ref["runs"]):
        for f in ("ckv", "krope"):
            assert getattr(c_b, f).dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(getattr(c_r, f)).view(np.uint16),
                getattr(c_f, f).view(torch.uint16).numpy())
            np.testing.assert_array_equal(
                getattr(c_t, f).view(torch.uint16).numpy(),
                getattr(c_b, f).view(np.uint16))
    nxt = tok[:, 8:9]
    want_r, _ = rtr.decode_step(pj, cr, rcache, jnp.asarray(nxt), mj)
    got_r, _ = rtr.decode_step(pj, cr, to_ref, jnp.asarray(nxt), mj)
    want_t, _ = ttr.decode_step(pt, ct, tcache, torch.from_numpy(nxt), mt)
    got_t, _ = ttr.decode_step(pt, ct, from_ref, torch.from_numpy(nxt), mt)
    _close(got_r, want_r, "bfloat16")
    _close(got_t, want_t, "bfloat16")
    _close(got_t, want_r, "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_masks_from_ratios_match_reference(dtype):
    """MLA's head axis: importance |w_uv| summed per head, heads kept one
    by one (not averaged over KV groups: a dense MLA stack with 4 heads
    and ``num_kv_heads`` 2 keeps 3 of 4 at ratio 0.75, where GQA groups of
    2 would keep 4); the dense layer's FFN unit and the MoE layer's expert
    unit beside it; ``min_keep`` as in the reference."""
    cr, ct, pj, pt, _, _ = _setup(dtype, seed=4, masked=False)
    units = rmasks.transformer_prunable_units(cr)
    assert tmasks.transformer_prunable_units(ct) == units
    assert [u["axis"] for u in units] == ["head_mask", "ffn_mask",
                                          "head_mask", "expert_mask"]
    n = len(units)
    for ratios, keep in ((list(np.random.default_rng(5).uniform(
            0.1, 1.0, n)), None), ([0.5] * n, None), ([0.0] * n, None),
            ([0.0] * n, {"expert_mask": 3, "head_mask": 2})):
        mr = rmasks.transformer_masks_from_ratios(pj, cr, ratios, keep)
        got = tmasks.transformer_masks_from_ratios(pt, ct, ratios, keep)
        assert len(mr) == len(got) == 2
        for a, b in zip(mr, got):
            assert sorted(a) == sorted(b)
            for axis in a:
                assert b[axis].dtype == torch.float32
                np.testing.assert_array_equal(np.asarray(a[axis]),
                                              b[axis].numpy())
    w = to_f32(pt["runs"][0]["attn"]["w_uv"][0]).reshape(
        ct.mla.kv_lora_rank, ct.num_heads, -1)
    imp = np.abs(w).sum((0, 2))
    half = tmasks.transformer_masks_from_ratios(pt, ct, [0.5] * n)
    np.testing.assert_array_equal(
        half[0]["head_mask"][0].numpy(),
        (imp >= np.sort(imp)[-2]).astype(np.float32))
    grouped = ct.replace(num_kv_heads=2)
    three = tmasks.transformer_masks_from_ratios(pt, grouped, [0.75] * n)
    assert float(three[0]["head_mask"][0].sum()) == 3
    np.testing.assert_array_equal(
        three[0]["head_mask"][0].numpy(), np.asarray(
            rmasks.transformer_masks_from_ratios(
                pj, cr.replace(num_kv_heads=2), [0.75] * n)[0][
                    "head_mask"][0]))


def test_full_config_builds_its_steps_on_the_card_path(monkeypatch):
    """``make_prefill_step`` and ``make_decode_step`` take the full
    DeepSeek-V3 config on the card path (``torch.cuda.is_available``
    patched true: building a step touches no device); MLA never reaches
    the flash kernel, so an MLA head dim the kernel has no instance of (32
    in the smoke config) is no reason to refuse, where a GQA one is.
    Capacity at the full config's expert count equals the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = treg.get_config(ARCH)
    assert callable(make_prefill_step(cfg))
    assert callable(make_decode_step(cfg))
    smoke = treg.get_smoke_config(ARCH)
    assert smoke.head_dim not in HEAD_DIMS
    assert callable(make_prefill_step(smoke))
    with pytest.raises(ValueError, match="head dims"):
        make_prefill_step(smoke.replace(attention="gqa"))
    full = rreg.get_config(ARCH).moe
    for tokens in (1, 16, 2048, 8192):
        assert tmoe.capacity(tokens, cfg.moe) == rmoe.capacity(tokens, full)
    assert ttr._rope_dim(cfg) == 64 and cfg.head_dim == 128
