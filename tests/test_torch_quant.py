"""The port's quantized edge path (``repro_torch.core.collab.quant``)
against the reference's ``repro.core.collab.quant``: byte-identical
weight codes, and ``quant_cnn_apply`` at every split, with the reference
running its Pallas kernel in interpret mode."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.collab import quant as rquant
from repro_torch.core.collab import quant as tquant
from torch_parity import fp32_tol, port_masks, port_params, ref_tree, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_params_byte_identical(bits, per_channel):
    cfg_r, cfg_t, params, _, _ = tiny_setup()
    pol_r = rquant.QuantPolicy(weight_bits=bits, per_channel=per_channel)
    pol_t = tquant.QuantPolicy(weight_bits=bits, per_channel=per_channel)
    assert pol_t.to_json() == pol_r.to_json()
    q_r = rquant.quantize_params(ref_tree(params), cfg_r, pol_r)
    q_t = tquant.quantize_params(port_params(params), cfg_t, pol_t)
    assert sorted(q_t) == sorted(q_r)
    for name in q_r:
        assert sorted(q_t[name]) == sorted(q_r[name])
        for leaf, want in q_r[name].items():
            want = np.asarray(want)
            got = q_t[name][leaf].numpy()
            assert got.dtype == want.dtype, (name, leaf)
            np.testing.assert_array_equal(got, want)


def test_policy_json_and_backend_resolution():
    for pol in (tquant.QuantPolicy(),
                tquant.QuantPolicy(weight_bits=4, per_channel=False),
                tquant.QuantPolicy(weight_bits=None, backend="ref")):
        assert tquant.QuantPolicy.from_json(pol.to_json()) == pol
        ref = rquant.QuantPolicy(**dataclasses.asdict(pol))
        assert pol.to_json() == ref.to_json()
    auto = tquant.QuantPolicy()
    assert tquant.resolve_backend(auto, torch.device("cpu")) == "ref"
    assert tquant.resolve_backend(auto, torch.device("cuda")) == "pallas"
    for name in ("ref", "pallas"):
        pol = tquant.QuantPolicy(backend=name)
        assert tquant.resolve_backend(pol, torch.device("cuda")) == name
    with pytest.raises(ValueError):
        tquant.QuantPolicy(backend="cuda")


@pytest.mark.parametrize("bits", [8, 4, None])
def test_quant_cnn_apply_every_split_matches_reference(bits):
    """Layer by layer on the masked (uncompacted) network, so the mask
    epilogue sees real zeros: the port's layer c on the reference's input
    to layer c agrees within ``fp32_tol`` at every split boundary, and the
    whole forward agrees too. Both packages dequantize identical codes, so
    the only gap is fp32 summation order."""
    cfg_r, cfg_t, params, masks, x = tiny_setup()
    pol_r = rquant.QuantPolicy(weight_bits=bits, backend="pallas")
    pol_t = tquant.QuantPolicy(weight_bits=bits, backend="pallas")
    q_r = rquant.quantize_params(ref_tree(params), cfg_r, pol_r)
    q_t = tquant.quantize_params(port_params(params), cfg_t, pol_t)
    m_r = {i: jnp.asarray(m) for i, m in masks.items()}
    m_t = port_masks(masks)
    cur = x
    for c in range(len(cfg_t.layers)):
        want = np.array(rquant.quant_cnn_apply(
            q_r, cfg_r, jnp.asarray(cur), masks=m_r, start_layer=c,
            stop_layer=c + 1, backend="pallas", interpret=True))
        got = tquant.quant_cnn_apply(q_t, cfg_t, torch.from_numpy(cur),
                                     masks=m_t, start_layer=c,
                                     stop_layer=c + 1, backend="pallas")
        assert got.shape == want.shape, c
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=fp32_tol(want), err_msg=f"layer {c}")
        cur = want
    got = tquant.quant_cnn_apply(q_t, cfg_t, torch.from_numpy(x), masks=m_t,
                                 backend="pallas").numpy()
    np.testing.assert_allclose(got, cur, rtol=0, atol=fp32_tol(cur))


def test_im2col_layout_matches_reference_patches():
    """``F.unfold`` patches, reshaped to NHWC, are the reference's
    ``conv_general_dilated_patches`` exactly (pure data movement)."""
    import jax
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 11, 3), dtype=np.float32)
    for k, s, p in ((3, 1, 1), (5, 2, 2), (3, 2, 0)):
        want = np.asarray(jax.lax.conv_general_dilated_patches(
            jnp.asarray(x), (k, k), (s, s), [(p, p)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
        got = tquant.im2col_nhwc(torch.from_numpy(x), k, s, p)
        assert got.is_contiguous()      # the CUDA kernel's operand rule
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_channel", [True, False])
def test_gemm_error_bound_matches_reference_and_holds(per_channel):
    """The per-layer int8 contract: |x @ dequant(w) - x @ w| stays within
    ``gemm_error_bound`` (plus fp32 slack), and the bound is the
    reference's."""
    cfg_r, cfg_t, params, _, _ = tiny_setup()
    pol = tquant.QuantPolicy(weight_bits=8, per_channel=per_channel)
    q = tquant.quantize_params(port_params(params), cfg_t, pol)
    rng = np.random.default_rng(7)
    for name in ("l0", "l10"):                  # a conv and a dense layer
        w = torch.from_numpy(params[name]["w"])
        w2 = w if w.dim() == 2 else torch.from_numpy(
            tquant.conv_weight_gemm_layout(params[name]["w"]))
        x = torch.from_numpy(rng.standard_normal((5, w2.shape[0]),
                                                 dtype=np.float32))
        bound = tquant.gemm_error_bound(x, q[name]["scale"])
        want = rquant.gemm_error_bound(jnp.asarray(x.numpy()),
                                       q[name]["scale"].numpy())
        np.testing.assert_allclose(bound.numpy(), np.asarray(want),
                                   rtol=1e-6)
        gap = (x @ tquant.dequantize_weights(q[name]) - x @ w2).abs()
        slack = 64 * np.finfo(np.float32).eps * (x.abs() @ w2.abs())
        assert (gap <= bound + slack).all()
