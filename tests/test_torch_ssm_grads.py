"""Gradients of the two kernel wrappers of the Mamba2 block, ``ssd_scan``
and ``gated_rmsnorm``: each is a ``torch.autograd.Function`` whose forward
is the wrapper's own path (the CUDA kernels for card tensors, the plain
version for CPU ones, so these CPU tests run the backward the card runs)
and whose backward is written by hand in PyTorch ops
(``ssd_scan_backward``, ``gated_rmsnorm_backward``). Held as
``test_torch_kernel_grads.py`` holds the other three:

* ``torch.autograd.gradcheck`` in float64 (the plain versions and the
  backwards compute in float64 for float64 operands), fast mode;
* against autograd through the plain version in float32 (within 64 eps
  of the largest entry) and bfloat16 (one bf16 spacing of each entry on
  top of that). For the bf16 scan the yardstick is the plain version's
  autograd at the same bf16 values in float32: its own bf16 autograd
  rounds partial sums of dB and dC to bf16 on their way back through the
  cast (measured 0.0078 off the float32 run at an entry of 5.4, where the
  Function is 0.0063 off, one rounding of its float32 result);
* against ``jax.vjp`` of the reference's ``repro.kernels.ssd_scan.ref.
  ssd_ref`` (times the head mask) and ``repro.models.layers.norms.
  gated_rmsnorm`` in float32, within 64 eps of the largest entry.

The SSD cases reach what the smoke configs miss: S past the chunk with a
ragged last chunk (chunk 8, S = 21), groups of B and C shared by 2 heads,
a partial and an all-zero head mask (a pruned head's dxh and ddt exactly
zero), and a given or a ``None`` gradient of the final state. The gated
cases take z as a strided slice of a wider projection, as the block does,
and hold the deliberate difference at |z| = 100, where the reference's
two-branch sigmoid gives a NaN gradient and the port's a finite one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd
from repro.models.layers.norms import gated_rmsnorm as j_gated
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from torch_parity import BF16_SPACING, EPS32, ssd_inputs, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

#: (name, B, S, H, G, P, N, chunk, head mask, gradient of the final state)
SSD = [("ragged_groups_dstate", 2, 21, 4, 2, 4, 5, 8, "partial", True),
       ("ragged_groups", 1, 21, 4, 2, 4, 5, 8, "partial", False),
       ("all_pruned", 1, 13, 2, 1, 4, 3, 8, "zeros", False),
       ("one_chunk_dstate", 2, 12, 3, 1, 4, 6, 32, None, True),
       ("whole_chunks", 1, 16, 4, 4, 3, 4, 8, "ones", False)]
#: (name, rows shape, d, width of the projection z is sliced from)
GATED = [("rows", (6,), 16, 16), ("ragged_3d", (2, 3), 13, 13),
         ("z_slice", (5,), 12, 31)]


def _mask(kind, H):
    if kind is None:
        return None
    m = {"zeros": np.zeros(H), "ones": np.ones(H)}.get(kind)
    if m is None:
        m = np.ones(H)
        m[1::2] = 0.0
    return m.astype(np.float32)


def _ssd_case(case, seed):
    """(operands x, dt, A, B, C as float32 numpy; head mask; dy; dstate or
    None; chunk)."""
    _, B, S, H, G, P, N, chunk, mask, dstate = case
    ops = ssd_inputs(B, S, H, G, P, N, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ds = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if dstate else None)
    return ops, _mask(mask, H), dy, ds, chunk


def _leaves(arrays, dtypes):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(d)
            .requires_grad_(True) for a, d in zip(arrays, dtypes)]


def _ssd_dtypes(dtype):
    """x, B, C in ``dtype``; dt and A float32, as the block gives them."""
    wide = torch.float32 if dtype != torch.float64 else dtype
    return (dtype, wide, wide, dtype, dtype)


def _ssd_grads(fn, inputs, mask, dy, ds, chunk):
    y, state = fn(*inputs, None if mask is None else torch.from_numpy(mask)
                  .to(inputs[1].dtype), chunk)
    outs, gs = [y], [torch.from_numpy(dy).to(y.dtype)]
    if ds is not None:
        outs.append(state)
        gs.append(torch.from_numpy(ds).to(state.dtype))
    return torch.autograd.grad(outs, inputs, gs)


def _close(got, want, dtype):
    got, want = to_f32(got), to_f32(want)
    tol = 64 * EPS32 * max(1.0, float(np.abs(want).max()))
    if dtype == torch.bfloat16:
        tol = tol + BF16_SPACING * np.abs(want)
    return (np.abs(got - want) <= tol).all()


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SSD, ids=[c[0] for c in SSD])
def test_ssd_scan_gradcheck(case):
    ops, mask, _, ds, chunk = _ssd_case(case, 0)
    hm = None if mask is None else torch.from_numpy(mask).double()

    def fn(*a):
        y, state = sops.ssd_scan(*a, hm, chunk)
        return (y, state) if ds is not None else y
    assert torch.autograd.gradcheck(
        fn, _leaves(ops, _ssd_dtypes(torch.float64)), fast_mode=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD, ids=[c[0] for c in SSD])
def test_ssd_scan_matches_plain_autograd(case, dtype):
    ops, mask, dy, ds, chunk = _ssd_case(case, 1)
    dtypes = _ssd_dtypes(dtype)
    got = _ssd_grads(sops.ssd_scan, _leaves(ops, dtypes), mask, dy, ds,
                     chunk)
    # the same values in float32 (bf16 operands and dy rounded first)
    ops = [to_f32(t) for t in _leaves(ops, dtypes)]
    dy = to_f32(torch.from_numpy(dy).to(dtype))
    want = _ssd_grads(ssd_scan_ref, _leaves(ops, [torch.float32] * 5),
                      mask, dy, ds, chunk)
    for a, b, d in zip(got, want, dtypes):
        assert a.dtype == d
        assert _close(a, b, dtype)
    if mask is not None and ds is None:    # a pruned head gets nothing
        pruned = torch.from_numpy(mask) == 0
        assert not got[0][:, :, pruned].any()
        assert not got[1][:, :, pruned].any()
        assert not got[2][pruned].any()


@pytest.mark.parametrize("case", SSD, ids=[c[0] for c in SSD])
def test_ssd_scan_matches_reference_vjp(case):
    ops, mask, dy, ds, chunk = _ssd_case(case, 2)
    m = np.ones(ops[0].shape[2], np.float32) if mask is None else mask

    def ref(x, dt, A, Bm, Cm):
        y, state = j_ssd(x, dt, A, Bm, Cm, chunk)
        return y * m[None, None, :, None], state
    _, pullback = jax.vjp(ref, *[jnp.asarray(a) for a in ops])
    state_bar = np.zeros((ops[0].shape[0], ops[0].shape[2],
                          ops[0].shape[3], ops[3].shape[3]), np.float32)
    want = pullback((jnp.asarray(dy),
                     jnp.asarray(state_bar if ds is None else ds)))
    got = _ssd_grads(sops.ssd_scan, _leaves(ops, _ssd_dtypes(torch.float32)),
                     mask, dy, ds, chunk)
    for a, b in zip(got, want):
        assert _close(a, np.asarray(b), torch.float32)


def test_ssd_scan_backward_takes_none_for_both_gradients():
    """An output autograd does not reach gives None: no gradient at all is
    zeros of every operand's shape and dtype."""
    ops, mask, *_ = _ssd_case(SSD[0], 3)
    t = [torch.from_numpy(a) for a in ops]
    grads = sops.ssd_scan_backward(*t, torch.from_numpy(mask), None, None, 8)
    for g, a in zip(grads, t):
        assert g.shape == a.shape and g.dtype == a.dtype
        assert not g.any()


# ---------------------------------------------------------------------------
# gated_rmsnorm
# ---------------------------------------------------------------------------
def _gated_case(case, seed):
    """(x, the projection z is sliced from, scale, g) as float32 numpy."""
    _, lead, d, width = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, d)).astype(np.float32)
    proj = (2 * rng.standard_normal((*lead, width))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((*lead, d)).astype(np.float32)
    return x, proj, scale, g


def _gated_fn(case, norm):
    """``norm(x, z, scale)`` with z the projection's columns from 3 on (the
    whole projection when it is as wide as x)."""
    _, _, d, width = case
    off = 0 if width == d else 3
    return lambda x, p, s: norm(x, p[..., off:off + d], s, 1e-6)


@pytest.mark.parametrize("case", GATED, ids=[c[0] for c in GATED])
def test_gated_rmsnorm_gradcheck(case):
    x, proj, scale, _ = _gated_case(case, 0)
    assert torch.autograd.gradcheck(
        _gated_fn(case, rops.gated_rmsnorm),
        _leaves((x, proj, scale), [torch.float64] * 3), fast_mode=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GATED, ids=[c[0] for c in GATED])
def test_gated_rmsnorm_matches_plain_autograd(case, dtype):
    x, proj, scale, g = _gated_case(case, 1)

    def grads(norm):
        ins = _leaves((x, proj, scale), [dtype] * 3)
        out = _gated_fn(case, norm)(*ins)
        return torch.autograd.grad(out, ins, torch.from_numpy(g).to(dtype))
    got, want = grads(rops.gated_rmsnorm), grads(gated_rmsnorm_ref)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _close(a, b, dtype)


@pytest.mark.parametrize("case", GATED, ids=[c[0] for c in GATED])
def test_gated_rmsnorm_matches_reference_vjp(case):
    x, proj, scale, g = _gated_case(case, 2)
    _, pullback = jax.vjp(_gated_fn(case, j_gated),
                          *[jnp.asarray(a) for a in (x, proj, scale)])
    want = pullback(jnp.asarray(g))
    ins = _leaves((x, proj, scale), [torch.float32] * 3)
    got = torch.autograd.grad(_gated_fn(case, rops.gated_rmsnorm)(*ins),
                              ins, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert _close(a, np.asarray(b), torch.float32)


def test_gated_rmsnorm_dz_is_finite_where_the_reference_gives_nan():
    """At z = ±100 the reference's ``jnp.where`` of two sigmoid branches
    differentiates the branch it did not take, whose exp overflows: dz is
    NaN there (and finite at z = -1, 2). The port's backward uses the
    stable sigmoid: dz is finite everywhere and agrees with the reference
    where the reference's is finite (ROADMAP §C)."""
    z = np.array([[-100.0, 100.0, -1.0, 2.0]], np.float32)
    x = np.array([[0.5, -1.5, 1.0, 2.0]], np.float32)
    scale = np.ones(4, np.float32)
    g = np.array([[1.0, -2.0, 0.5, 1.5]], np.float32)
    _, pullback = jax.vjp(lambda z: j_gated(jnp.asarray(x), z,
                                            jnp.asarray(scale)),
                          jnp.asarray(z))
    want = np.asarray(pullback(jnp.asarray(g))[0])
    assert np.isnan(want[0, :2]).all() and np.isfinite(want[0, 2:]).all()
    zt = torch.from_numpy(z).requires_grad_(True)
    got = torch.autograd.grad(
        rops.gated_rmsnorm(torch.from_numpy(x), zt, torch.from_numpy(scale)),
        zt, torch.from_numpy(g))[0].numpy()
    assert np.isfinite(got).all()
    assert np.abs(got[0, 2:] - want[0, 2:]).max() <= 64 * EPS32
    # at z = 100 the gate is the identity: dz = du·x; at z = -100 it is ~0
    assert abs(got[0, 0]) <= 1e-30
