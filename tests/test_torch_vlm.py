"""The port's vision-language path (Qwen2-VL: a vision prefix before the
text and M-RoPE angles) against the reference on the same numpy inputs, at
the smoke size: ``qwen2-vl-7b``'s smoke config (2 layers, d_model 256, 4
query / 2 KV heads of 64, d_ff 512, vocab 512, 16 vision tokens, M-RoPE
sections 8/12/12). The vision embeddings are standard normal draws (the
reference stubs its ViT the same way); the M-RoPE ids put the prefix on
a 4 x 4 grid and the text after it (``grid_mrope_positions``).

The reference runs with its Pallas kernels in interpret mode and with
dispatch off (``both_reference_paths``). On the CPU every wrapper of the
port runs its plain version.

Tolerances: ``mrope_angles`` and the embedding seam are bit-equal (the
same float32 products, selected; the same casts to bf16). Logits, as
``test_torch_transformer.py`` states them (``stack_tol``): float32 within
64 eps of the largest logit (the same math in other summation orders),
bf16 within 4 bf16 spacings of it (bf16 rounds at other points in XLA and
PyTorch; the reference's own two paths differ by about 1 spacing here).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core.pruning import masks as rmasks
from repro.models import transformer as rtr
from repro.models.layers import rope as rrope
from repro_torch.configs import registry as treg
from repro_torch.core.pruning import masks as tmasks
from repro_torch.data.requests import grid_mrope_positions
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import rope as trope
from torch_parity import (both_reference_paths, model_batch_np, stack_tol,
                          to_f32, transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

ARCH = "qwen2-vl-7b"
SIDE = 4          # the smoke config's 16 vision tokens on a 4 x 4 grid
#: (head_dim, sections) of the smoke and the published config
ROPE_DIMS = {"smoke": (64, (8, 12, 12)), "full": (128, (16, 24, 24))}


def _setup(dtype="float32", masked=True, seed=0):
    cr = rreg.get_smoke_config(ARCH).replace(dtype=dtype)
    ct = treg.get_smoke_config(ARCH).replace(dtype=dtype)
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


def _batch(cfg, B, T, seed=2, grid=True):
    """numpy batch of T text tokens after the vision prefix, with the grid
    M-RoPE ids (or none: the stack's text positions)."""
    batch = model_batch_np(cfg, B, T, seed)
    if grid:
        batch["mrope_positions"] = grid_mrope_positions(B, SIDE, T)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dims", sorted(ROPE_DIMS))
@pytest.mark.parametrize("positions", ["text", "text_offset", "grid"])
def test_mrope_angles_bit_equal_to_reference(positions, dims):
    """Text ids (t = h = w, from 0 or from a per-sequence offset) and a
    4 x 4 grid prefix: the port's gather of each band's axis gives the
    reference's one-hot einsum bit for bit."""
    head_dim, sections = ROPE_DIMS[dims]
    B, S = 2, 24
    if positions == "grid":
        pos = grid_mrope_positions(B, SIDE, S - SIDE * SIDE)
    else:
        off = np.array([0, 7]) if positions == "text_offset" else 0
        pos = np.array(rrope.text_mrope_positions(B, S, jnp.asarray(off)))
        got_pos = trope.text_mrope_positions(B, S, torch.as_tensor(off))
        assert got_pos.dtype == torch.int32
        np.testing.assert_array_equal(got_pos.numpy(), pos)
    want = np.asarray(rrope.mrope_angles(jnp.asarray(pos), head_dim, 1e6,
                                         sections))
    got = trope.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tuple(got.shape) == want.shape == (B, S, head_dim // 2)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("head_dim", [64, 80, 128, 192, 256])
def test_rope_freqs_bit_equal_to_reference(head_dim):
    """The inverse frequencies every rotary angle starts from, at each
    head dim of the registry and both thetas it uses, bit for bit (the
    power rounded once from float64, as the reference's float32 power
    rounds)."""
    for theta in (1e4, 1e6):
        want = np.asarray(rrope.rope_freqs(head_dim, theta))
        got = trope.rope_freqs(head_dim, theta).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mrope_refuses_positions_or_sections_that_do_not_fit():
    pos = trope.text_mrope_positions(1, 4)
    with pytest.raises(ValueError, match="sections"):
        trope.mrope_angles(pos, 64, 1e6, (8, 12, 8))
    with pytest.raises(ValueError, match="leading axis"):
        trope.mrope_angles(pos[:2], 64, 1e6, (8, 12, 12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_prefix_is_cast_before_the_concatenation(dtype):
    """The seam: float32 vision embeddings cast to the embedding table's
    dtype, then put before the text embeddings, bit for bit."""
    cr, ct, pj, pt, _, _ = _setup(dtype, masked=False)
    batch = _batch(ct, 2, 5)
    want, B, S = rtr.embed_inputs(pj, cr, _jax(batch))
    got, Bt, St = ttr.embed_inputs(pt, ct, _torch(batch))
    assert (Bt, St) == (B, S) == (2, ct.vision_tokens + 5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(transformer_params_to_reference(got)
                                  .view(np.uint8),
                                  np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "text_ids"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(dtype, masked, grid):
    """16 vision + 12 text tokens: every position's logits (``forward``)
    and the prefill step's last logits, against both reference paths."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, masked=masked)
    batch = _batch(ct, 2, 12, grid=grid)
    S = ct.vision_tokens + 12
    got = ttr.forward(pt, ct, _torch(batch), mt)[0]
    assert got.shape == (2, S, ct.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    lg, cache = make_prefill_step(ct, max_len=S + 2, masks=mt,
                                  device="cpu")(pt, batch)
    assert cache["pos"].tolist() == [S, S]
    refs = both_reference_paths(lambda: (
        to_f32(rtr.forward(pj, cr, _jax(batch), mj)[0]),
        to_f32(rtr.prefill(pj, cr, _jax(batch), max_len=S + 2,
                           masks=mj)[0])))
    for want_all, want_last in refs:
        assert np.abs(to_f32(got) - want_all).max() <= stack_tol(want_all,
                                                                  dtype)
        assert np.abs(to_f32(lg) - want_last).max() <= stack_tol(want_last,
                                                                 dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """A prefill of the vision prefix and 9 text tokens on the grid ids,
    then 3 decode steps through the steps a server calls, against the
    reference's own prefill and decode_step. Then cache consistency on
    text ids, as the reference's decode-consistency test holds it: the
    prefill and the decode steps give the port's own full forward's rows
    (grid ids and the decode position are not consistent by construction,
    in the reference too)."""
    cr, ct, pj, pt, mj, mt = _setup(dtype, seed=1)
    B, T, n_dec = 2, 12, 3
    full = _batch(ct, B, T, seed=3)
    tok = full["tokens"]
    pre = dict(full, tokens=tok[:, :T - n_dec],
               mrope_positions=grid_mrope_positions(B, SIDE, T - n_dec))
    max_len = ct.vision_tokens + T + 2

    def reference():
        lg, cache = rtr.prefill(pj, cr, _jax(pre), max_len=max_len, masks=mj)
        outs = [to_f32(lg)]
        for t in range(T - n_dec, T):
            lg, cache = rtr.decode_step(pj, cr, cache,
                                        jnp.asarray(tok[:, t:t + 1]), mj)
            outs.append(to_f32(lg))
        return np.stack(outs, 1)

    def port(batch):
        prefill = make_prefill_step(ct, max_len=max_len, masks=mt,
                                    device="cpu")
        decode = make_decode_step(ct, masks=mt, device="cpu")
        lg, cache = prefill(pt, batch)
        outs = [to_f32(lg)]
        for t in range(T - n_dec, T):
            lg, cache = decode(pt, cache, tok[:, t:t + 1])
            outs.append(to_f32(lg))
        assert cache["pos"].tolist() == [ct.vision_tokens + T] * B
        return np.stack(outs, 1)

    got = port(pre)
    for want in both_reference_paths(reference):
        assert np.abs(got - want).max() <= stack_tol(want, dtype)
    text_ids = {k: v for k, v in pre.items() if k != "mrope_positions"}
    got = port(text_ids)
    rows = to_f32(ttr.forward(pt, ct, _torch({k: v for k, v in full.items()
                                              if k != "mrope_positions"}),
                              mt)[0])[:, -n_dec - 1:]
    assert np.abs(got - rows).max() <= stack_tol(rows, dtype)


def test_decode_position_counts_the_vision_prefix():
    """After a prefill of V vision and T text tokens on the grid ids, the
    decode step rotates its token at position V + T on all three axes (the
    reference's ``cache["pos"]``), not at the grid's largest id + 1 + T
    where Qwen2-VL's own numbering would put it: in both packages the
    step's logits equal a forward whose last token has the ids (V + T,) *
    3, and differ from one at the published continuation."""
    cr, ct, pj, pt, mj, mt = _setup("float32", seed=4)
    B, T = 2, 6
    V = ct.vision_tokens
    full = _batch(ct, B, T + 1, seed=5)
    tok = full["tokens"]
    pre = dict(full, tokens=tok[:, :T],
               mrope_positions=grid_mrope_positions(B, SIDE, T))
    lg, cache = ttr.prefill(pt, ct, _torch(pre), masks=mt, max_len=V + T + 1)
    lg, cache = ttr.decode_step(pt, ct, cache, torch.from_numpy(tok[:, T:]),
                                mt)
    rlg, rcache = rtr.prefill(pj, cr, _jax(pre), masks=mj, max_len=V + T + 1)
    rlg, _ = rtr.decode_step(pj, cr, rcache, jnp.asarray(tok[:, T:]), mj)
    got, ref = to_f32(lg), to_f32(rlg)

    def last_at(p):
        ids = grid_mrope_positions(B, SIDE, T + 1)
        ids[:, :, -1] = p
        batch = dict(full, mrope_positions=ids)
        return (to_f32(ttr.forward(pt, ct, _torch(batch), mt)[0])[:, -1],
                to_f32(rtr.forward(pj, cr, _jax(batch), mj)[0])[:, -1])
    at_pos, ref_at_pos = last_at(V + T)
    assert np.abs(got - at_pos).max() <= stack_tol(at_pos, "float32")
    assert np.abs(ref - ref_at_pos).max() <= stack_tol(ref_at_pos, "float32")
    assert np.abs(got - ref).max() <= stack_tol(ref, "float32")
    at_grid, _ = last_at(SIDE + T)
    assert np.abs(got - at_grid).max() > 100 * stack_tol(at_grid, "float32")


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
    mine = tmasks.transformer_masks_from_ratios(
        pt, ct, [0.5] * len(tmasks.transformer_prunable_units(ct)))
    theirs = rmasks.transformer_masks_from_ratios(
        pj, cr, [0.5] * len(rmasks.transformer_prunable_units(cr)))
    handed = jax.tree_util.tree_map(jnp.asarray,
                                    transformer_params_to_reference(mine))
    batch = _jax(_batch(ct, 1, 4))
    np.testing.assert_array_equal(
        to_f32(rtr.forward(pj, cr, batch, handed)[0]),
        to_f32(rtr.forward(pj, cr, batch, theirs)[0]))
    for a, b in zip(mj, mt):
        for axis in a:
            np.testing.assert_array_equal(np.asarray(a[axis]),
                                          b[axis].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_units_and_masks_equal_reference(dtype):
    """A head and an FFN unit a layer; the kept heads (whole KV groups)
    and FFN channels at random ratios and at the chip run's 0.5 equal the
    reference's."""
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
