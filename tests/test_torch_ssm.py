"""The port's Mamba2 block (``repro_torch.models.layers.ssm``) against the
reference's on the same numpy parameters and inputs, at the smoke size of
mamba2-2.7b (d_model 256, d_inner 512, 16 SSD heads of 32, d_state 32,
chunk 32) in float32 and bfloat16: the full-sequence forward with and
without the state it hands to decode, the one-token decode, and the
handoff between them.

The reference runs with its Pallas scan in interpret mode
(``dispatch.use_pallas(interpret=True)``) and with dispatch off; on the
CPU the port's scan wrapper runs its plain version.

Tolerances: float32 within 64 eps of the largest output (the same math in
other summation orders; measured under 8 eps); bfloat16 within 4 bf16
spacings (2**-5) of the largest output — bf16 rounds at other points in
XLA and PyTorch (the conv taps, y before the gated norm), and the
reference's own two paths differ by about one spacing of it here. The
float32 SSD state and the conv tail handed to decode are held the same
way, relative to their own largest entry: in a bf16 model the state is
computed from bf16 conv outputs, so it inherits their roundings.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.kernels import dispatch
from repro.models.layers import ssm as rssm
from repro_torch.configs import registry as treg
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import ssm as tssm
from torch_parity import BF16_SPACING, EPS32, to_f32, transformer_params_np


def _tol(want, dtype: str) -> float:
    big = max(1.0, float(np.abs(to_f32(want)).max()))
    return (64 * EPS32 if dtype == "float32" else 4 * BF16_SPACING) * big


def _setup(dtype="float32", seed=0, arch="mamba2-2.7b"):
    """(cfg_ref, cfg_port, layer params numpy, head mask numpy): layer 0 of
    the smoke model's parameter tree (``transformer_params_np``: SSD decay
    parameters in the reference's ranges, float32 A_log/dt_bias/D)."""
    cr = rreg.get_smoke_config(arch).replace(dtype=dtype)
    ct = treg.get_smoke_config(arch).replace(dtype=dtype)
    tree = transformer_params_np(cr, seed)["runs"][0]["ssm"]
    lp = {k: v[0] for k, v in tree.items()}
    hm = np.zeros(cr.ssm_heads, np.float32)
    hm[np.random.default_rng(seed + 1).permutation(cr.ssm_heads)[
        :cr.ssm_heads // 2]] = 1.0
    return cr, ct, lp, hm


def _x(cfg, B, S, seed=2):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    return x.astype(np.float32).astype(jnp.dtype(cfg.dtype))


def _both_reference_paths(fn):
    with dispatch.use_pallas(interpret=True):
        on = fn()
    return on, fn()


def test_init_ssm_params_has_the_reference_layout():
    cr, ct, _, _ = _setup("bfloat16")
    want = jax.eval_shape(lambda: rssm.init_ssm_params(
        jax.random.PRNGKey(0), cr, jnp.bfloat16))
    got = tssm.init_ssm_params(torch.Generator().manual_seed(0), ct,
                               torch.bfloat16, torch.device("cpu"))
    assert sorted(want) == sorted(got)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    assert got["A_log"].dtype == got["dt_bias"].dtype == torch.float32
    np.testing.assert_allclose(
        got["A_log"].numpy(),
        np.log(np.linspace(1.0, 16.0, ct.ssm_heads)), rtol=1e-6)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert ((dt > 0.999e-3) & (dt < 1.001e-1)).all()
    assert (got["D"] == 1).all() and (got["conv_b"] == 0).all()
    assert tssm.conv_dim(ct) == rssm.conv_dim(cr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """The taps summed one at a time in the model's dtype, then SiLU in
    float32."""
    cr, ct, lp, _ = _setup(dtype)
    xBC = np.random.default_rng(3).standard_normal(
        (2, 19, rssm.conv_dim(cr))).astype(np.float32).astype(
        jnp.dtype(cr.dtype))
    want = rssm._causal_conv(jnp.asarray(xBC), jnp.asarray(lp["conv_w"]),
                             jnp.asarray(lp["conv_b"]), cr.ssm.d_conv)
    got = tssm._causal_conv(to_port(xBC), to_port(lp["conv_w"]),
                            to_port(lp["conv_b"]), ct.ssm.d_conv)
    assert got.dtype == to_port(xBC).dtype
    assert np.abs(to_f32(got) - to_f32(want)).max() <= _tol(want, dtype)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, masked):
    """ssm_forward with and without ``return_state`` (S = 70: two whole
    chunks and a ragged one): the output, the conv tail and the SSD
    state."""
    cr, ct, lp, hm = _setup(dtype)
    x = _x(cr, 2, 70)
    pj = {k: jnp.asarray(v) for k, v in lp.items()}
    pt = to_port(lp)
    hmj = jnp.asarray(hm) if masked else None
    hmt = torch.from_numpy(hm) if masked else None
    got = tssm.ssm_forward(pt, ct, to_port(x), head_mask=hmt)
    got_o, got_c = tssm.ssm_forward(pt, ct, to_port(x), head_mask=hmt,
                                    return_state=True)
    assert got.dtype == to_port(x).dtype and got.shape == x.shape
    assert torch.equal(got, got_o)
    for want_o, want_c in _both_reference_paths(
            lambda: rssm.ssm_forward(pj, cr, jnp.asarray(x), head_mask=hmj,
                                     return_state=True)):
        assert np.abs(to_f32(got) - to_f32(want_o)).max() <= _tol(want_o,
                                                                  dtype)
        assert got_c.conv.dtype == got_o.dtype
        assert np.abs(to_f32(got_c.conv) - to_f32(want_c.conv)).max() \
            <= _tol(want_c.conv, dtype)
        st = to_f32(want_c.state)
        assert got_c.state.dtype == torch.float32
        assert np.abs(to_f32(got_c.state) - st).max() <= _tol(st, dtype)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompts_left_pad_the_conv_tail(S):
    """S < d_conv - 1: the tail is the raw pre-conv inputs, left-padded
    with zeros to d_conv - 1 rows, as in the reference."""
    cr, ct, lp, hm = _setup("bfloat16")
    x = _x(cr, 2, S, seed=4)
    _, want = rssm.ssm_forward({k: jnp.asarray(v) for k, v in lp.items()},
                               cr, jnp.asarray(x), head_mask=jnp.asarray(hm),
                               return_state=True)
    _, got = tssm.ssm_forward(to_port(lp), ct, to_port(x),
                              head_mask=torch.from_numpy(hm),
                              return_state=True)
    K = ct.ssm.d_conv
    assert tuple(got.conv.shape) == (2, K - 1, tssm.conv_dim(ct))
    assert (got.conv[:, :K - 1 - S] == 0).all()
    assert np.abs(to_f32(got.conv) - to_f32(want.conv)).max() \
        <= _tol(want.conv, "bfloat16")
    assert np.abs(to_f32(got.state) - to_f32(want.state)).max() \
        <= _tol(want.state, "bfloat16")


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(dtype, masked):
    """One token against a random cache (conv window in the model's dtype,
    float32 state): the output and the new cache."""
    cr, ct, lp, hm = _setup(dtype, seed=5)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, cr.ssm.d_conv - 1, rssm.conv_dim(cr)))
    conv = conv.astype(np.float32).astype(jnp.dtype(cr.dtype))
    state = rng.standard_normal((2, cr.ssm_heads, cr.ssm.head_dim,
                                 cr.ssm.d_state)).astype(np.float32)
    x = _x(cr, 2, 1, seed=7)
    want_o, want_c = rssm.ssm_decode(
        {k: jnp.asarray(v) for k, v in lp.items()}, cr, jnp.asarray(x),
        rssm.SSMCache(jnp.asarray(conv), jnp.asarray(state)),
        head_mask=jnp.asarray(hm) if masked else None)
    cache = tssm.SSMCache(to_port(conv), torch.from_numpy(state))
    got_o, got_c = tssm.ssm_decode(
        to_port(lp), ct, to_port(x), cache,
        head_mask=torch.from_numpy(hm) if masked else None)
    assert got_o.dtype == to_port(x).dtype and got_o.shape == x.shape
    assert np.abs(to_f32(got_o) - to_f32(want_o)).max() <= _tol(want_o,
                                                                dtype)
    assert torch.equal(got_c.conv[:, :-1], to_port(conv)[:, 1:])
    assert np.abs(to_f32(got_c.conv) - to_f32(want_c.conv)).max() \
        <= _tol(want_c.conv, dtype)
    assert np.abs(to_f32(got_c.state) - to_f32(want_c.state)).max() \
        <= _tol(want_c.state, "float32")
    assert torch.equal(cache.conv, to_port(conv))    # input left untouched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_continues_the_full_forward(dtype):
    """The state handoff: ssm_forward over the first S - 4 steps with
    ``return_state``, then 4 decode steps, gives the full forward's last 4
    outputs (the reference's own prefill and decode differ in precision —
    a bf16 conv in prefill, a float32 one in decode — so bf16 holds at its
    spacing), and matches the reference doing the same."""
    cr, ct, lp, hm = _setup(dtype, seed=8)
    S, n = 37, 4
    x = _x(cr, 2, S, seed=9)
    pt, hmt = to_port(lp), torch.from_numpy(hm)
    full = to_f32(tssm.ssm_forward(pt, ct, to_port(x), head_mask=hmt))
    out, cache = tssm.ssm_forward(pt, ct, to_port(x[:, :S - n]),
                                  head_mask=hmt, return_state=True)
    steps = []
    for t in range(S - n, S):
        o, cache = tssm.ssm_decode(pt, ct, to_port(x[:, t:t + 1]), cache,
                                   head_mask=hmt)
        steps.append(to_f32(o))
    got = np.concatenate(steps, 1)
    assert np.abs(got - full[:, S - n:]).max() <= _tol(full, dtype)
    assert np.abs(to_f32(out) - full[:, :S - n]).max() <= _tol(full, dtype)

    pj = {k: jnp.asarray(v) for k, v in lp.items()}
    _, rc = rssm.ssm_forward(pj, cr, jnp.asarray(x[:, :S - n]),
                             head_mask=jnp.asarray(hm), return_state=True)
    want = []
    for t in range(S - n, S):
        o, rc = rssm.ssm_decode(pj, cr, jnp.asarray(x[:, t:t + 1]), rc,
                                head_mask=jnp.asarray(hm))
        want.append(to_f32(o))
    want = np.concatenate(want, 1)
    assert np.abs(got - want).max() <= _tol(want, dtype)


def test_forward_launches_nothing_on_the_cpu_and_ref_backend_agrees():
    cr, ct, lp, hm = _setup("bfloat16", seed=10)
    x = to_port(_x(cr, 1, 40, seed=11))
    before = ssd_scan.launches
    auto = tssm.ssm_forward(to_port(lp), ct, x,
                            head_mask=torch.from_numpy(hm))
    ref = tssm.ssm_forward(to_port(lp), ct, x,
                           head_mask=torch.from_numpy(hm), backend="ref")
    assert torch.equal(auto, ref)
    assert ssd_scan.launches == before
