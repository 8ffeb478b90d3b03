"""Gradients of the port's kernel wrappers (``rmsnorm``, ``masked_matmul``,
``flash_attention``; ``gated_rmsnorm`` and ``ssd_scan`` are held the same
ways in ``test_torch_ssm_grads.py``): each is a
``torch.autograd.Function`` whose forward is the wrapper's own path (the
CUDA kernel for a card tensor, the plain version for a CPU one, so these
CPU tests run the backward the card runs) and whose backward is written
in PyTorch ops. Held three ways:

* ``torch.autograd.gradcheck`` in float64 (the plain versions and the
  backwards compute in float64 for float64 operands), in its fast mode:
  the Jacobian against random directions of inputs and outputs, a few
  evaluations rather than one per input entry;
* against autograd through the plain version in float32 (within 64 eps
  of the largest entry: the same sums in other orders) and bfloat16 (one
  bf16 spacing of each entry on top of that: both round an fp32 result to
  bf16 once);
* against ``jax.vjp`` of the reference's plain kernels
  (``repro.kernels.*.ref``) in float32, within 64 eps of the largest
  entry.

Flash cases cover causal, non-causal, a window, GQA groups of 1, 2 and 4,
keys past ``seq_k``, a ragged length and head dim 80; masked_matmul a
partial and an all-zero mask (a pruned column's dB is exactly zero). With
no operand requiring a gradient, or grad mode off, every wrapper of the
five takes the serving path: no Function, no ``grad_fn``, the same launch
counts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.kernels.masked_matmul.ref import masked_matmul_ref as j_masked
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm
from repro_torch.kernels import needs_grad
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.masked_matmul import ops as mops
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as sops
from torch_parity import BF16_SPACING, EPS32, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

#: (name, B, S, H, Hkv, D, causal, window, seq_k)
FLASH = [("causal_gqa2", 2, 9, 4, 2, 16, True, None, None),
         ("noncausal_mha", 1, 7, 2, 2, 16, False, None, None),
         ("window_gqa4", 2, 11, 4, 1, 8, True, 4, None),
         ("seq_k", 1, 9, 4, 2, 16, True, None, 6),
         ("noncausal_seq_k", 2, 8, 2, 1, 8, False, None, 5),
         ("ragged_d80", 1, 5, 2, 2, 80, False, None, None),
         ("noncausal_window", 1, 10, 8, 2, 8, False, 3, None)]
#: (name, lead shape of a, K, N, mask)
MATMUL = [("partial_2d", (6,), 8, 10, "partial"),
          ("partial_3d", (2, 3), 8, 10, "partial"),
          ("all_zero", (5,), 7, 6, "zeros"),
          ("ones", (4,), 9, 5, "ones")]
#: (name, shape of x, scale offset)
NORM = [("rows", (6, 16), 0.0), ("gemma_offset", (2, 3, 16), 1.0),
        ("ragged", (5, 13), 0.0)]


def _mask(kind: str, N: int, rng) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(N, np.float32)
    if kind == "ones":
        return np.ones(N, np.float32)
    m = (rng.random(N) < 0.5).astype(np.float32)
    m[0], m[-1] = 1.0, 0.0
    return m


def _flash_inputs(case, rng):
    _, B, S, H, Hkv, D, *_ = case
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _leaves(arrays, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in arrays]


def _flash(case):
    *_, causal, window, seq_k = case
    return lambda q, k, v: fops.flash_attention(q, k, v, causal=causal,
                                                window=window, seq_k=seq_k)


def _flash_plain(case):
    """Autograd through the plain version itself (keys cut at seq_k)."""
    *_, causal, window, seq_k = case

    def fn(q, k, v):
        n = k.shape[1] if seq_k is None else seq_k
        return attention_ref(q, k[:, :n], v[:, :n], causal=causal,
                             window=window, scale=q.shape[-1] ** -0.5)
    return fn


def _grads(fn, inputs, g):
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, g.to(out.dtype))


def _close(got, want, dtype):
    got, want = to_f32(got), to_f32(want)
    tol = 64 * EPS32 * max(1.0, float(np.abs(want).max()))
    if dtype == torch.bfloat16:
        tol = tol + BF16_SPACING * np.abs(want)
    return (np.abs(got - want) <= tol).all()


# ---------------------------------------------------------------------------
# gradcheck in float64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_attention_gradcheck(case):
    q, k, v, _ = _flash_inputs(case, np.random.default_rng(0))
    assert torch.autograd.gradcheck(_flash(case),
                                    _leaves((q, k, v), torch.float64),
                                    fast_mode=True)


@pytest.mark.parametrize("case", MATMUL, ids=[c[0] for c in MATMUL])
def test_masked_matmul_gradcheck(case):
    _, lead, K, N, kind = case
    rng = np.random.default_rng(1)
    a = rng.standard_normal((*lead, K))
    b = rng.standard_normal((K, N))
    mask = torch.from_numpy(_mask(kind, N, rng)).to(torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b: mops.masked_matmul(a, b, mask),
        _leaves((a, b), torch.float64), fast_mode=True)


@pytest.mark.parametrize("case", NORM, ids=[c[0] for c in NORM])
def test_rmsnorm_gradcheck(case):
    _, shape, offset = case
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape)
    scale = 1.0 + 0.1 * rng.standard_normal(shape[-1:])
    assert torch.autograd.gradcheck(
        lambda x, s: rops.rmsnorm(x, s, 1e-6, offset),
        _leaves((x, scale), torch.float64), fast_mode=True)


# ---------------------------------------------------------------------------
# against the plain version's autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_attention_matches_plain_autograd(case, dtype):
    q, k, v, g = _flash_inputs(case, np.random.default_rng(3))
    g = torch.from_numpy(g)
    got = _grads(_flash(case), _leaves((q, k, v), dtype), g)
    want = _grads(_flash_plain(case), _leaves((q, k, v), dtype), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _close(a, b, dtype)
    if case[-1] is not None:       # keys at or past seq_k get zero
        assert not got[1][:, case[-1]:].any()
        assert not got[2][:, case[-1]:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MATMUL, ids=[c[0] for c in MATMUL])
def test_masked_matmul_matches_plain_autograd(case, dtype):
    _, lead, K, N, kind = case
    rng = np.random.default_rng(4)
    a = rng.standard_normal((*lead, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    mask = torch.from_numpy(_mask(kind, N, rng))
    g = torch.from_numpy(rng.standard_normal((*lead, N)).astype(np.float32))
    got = _grads(lambda a, b: mops.masked_matmul(a, b, mask),
                 _leaves((a, b), dtype), g)
    want = _grads(lambda a, b: masked_matmul_ref(a, b, mask),
                  _leaves((a, b), dtype), g)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        assert _close(x, y, dtype)
    # a pruned column's dB is exactly zero; an all-zero mask gives zeros
    assert not got[1][:, mask == 0].any()
    if kind == "zeros":
        assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", NORM, ids=[c[0] for c in NORM])
def test_rmsnorm_matches_plain_autograd(case, dtype):
    _, shape, offset = case
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = _grads(lambda x, s: rops.rmsnorm(x, s, 1e-6, offset),
                 _leaves((x, scale), dtype), g)
    want = _grads(lambda x, s: rmsnorm_ref(x, s, 1e-6, offset),
                  _leaves((x, scale), dtype), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _close(a, b, dtype)


# ---------------------------------------------------------------------------
# against jax.vjp of the reference's plain kernels
# ---------------------------------------------------------------------------
def _vjp(fn, primals, g):
    _, pullback = jax.vjp(fn, *[jnp.asarray(p) for p in primals])
    return [np.asarray(t) for t in pullback(jnp.asarray(g))]


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_attention_matches_reference_vjp(case):
    *_, causal, window, seq_k = case
    q, k, v, g = _flash_inputs(case, np.random.default_rng(6))
    n = k.shape[1] if seq_k is None else seq_k
    want = _vjp(lambda q, k, v: j_attention(q, k, v, causal=causal,
                                            window=window),
                (q, k[:, :n], v[:, :n]), g)
    pad = ((0, 0), (0, k.shape[1] - n), (0, 0), (0, 0))
    want = [want[0], np.pad(want[1], pad), np.pad(want[2], pad)]
    got = _grads(_flash(case), _leaves((q, k, v), torch.float32),
                 torch.from_numpy(g))
    for a, b in zip(got, want):
        assert _close(a, b, torch.float32)


@pytest.mark.parametrize("case", MATMUL, ids=[c[0] for c in MATMUL])
def test_masked_matmul_matches_reference_vjp(case):
    _, lead, K, N, kind = case
    rng = np.random.default_rng(7)
    a = rng.standard_normal((*lead, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    mask = _mask(kind, N, rng)
    g = rng.standard_normal((*lead, N)).astype(np.float32)
    want = _vjp(lambda a, b: j_masked(a.reshape(-1, K), b, mask)
                .reshape(*lead, N), (a, b), g)
    got = _grads(lambda a, b: mops.masked_matmul(a, b,
                                                 torch.from_numpy(mask)),
                 _leaves((a, b), torch.float32), torch.from_numpy(g))
    for x, y in zip(got, want):
        assert _close(x, y, torch.float32)


@pytest.mark.parametrize("case", NORM, ids=[c[0] for c in NORM])
def test_rmsnorm_matches_reference_vjp(case):
    _, shape, offset = case
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = _vjp(lambda x, s: j_rmsnorm(x, s, 1e-6, offset), (x, scale), g)
    got = _grads(lambda x, s: rops.rmsnorm(x, s, 1e-6, offset),
                 _leaves((x, scale), torch.float32), torch.from_numpy(g))
    for a, b in zip(got, want):
        assert _close(a, b, torch.float32)


# ---------------------------------------------------------------------------
# routing: the serving path is untouched
# ---------------------------------------------------------------------------
def _calls():
    """One call of each wrapper: (name, Function, call(requires_grad))."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    s = np.ones(16, np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    m = torch.ones(8)
    q, k, v, _ = _flash_inputs(FLASH[0], rng)
    z = rng.standard_normal((4, 16)).astype(np.float32)
    xh = rng.standard_normal((1, 5, 2, 4)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (1, 5, 2)).astype(np.float32)
    A = -np.array([1.0, 4.0], np.float32)
    bc = rng.standard_normal((1, 5, 1, 3)).astype(np.float32)
    hm = torch.tensor([1.0, 0.0])
    return [
        ("rmsnorm", rops._RMSNorm,
         lambda rg: rops.rmsnorm(*_maybe((x, s), rg))),
        ("masked_matmul", mops._MaskedMatmul,
         lambda rg: mops.masked_matmul(*_maybe((x, b), rg), m)),
        ("flash_attention", fops._FlashAttention,
         lambda rg: fops.flash_attention(*_maybe((q, k, v), rg))),
        ("gated_rmsnorm", rops._GatedRMSNorm,
         lambda rg: rops.gated_rmsnorm(*_maybe((x, z, s), rg))),
        ("ssd_scan", sops._SSDScan,
         lambda rg: sops.ssd_scan(*_maybe((xh, dt, A, bc, bc), rg), hm,
                                  4)[0])]


def _maybe(arrays, requires_grad):
    return [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in arrays]


def _counts():
    return (rops.rmsnorm.launches, mops.masked_matmul.launches,
            dict(mops.masked_matmul.route_launches),
            fops.flash_attention.launches, rops.gated_rmsnorm.launches,
            sops.ssd_scan.launches)


WRAPPERS = ["rmsnorm", "masked_matmul", "flash_attention", "gated_rmsnorm",
            "ssd_scan"]


@pytest.mark.parametrize("index", range(len(WRAPPERS)), ids=WRAPPERS)
def test_no_grad_takes_the_serving_path(index, monkeypatch):
    name, fn_cls, call = _calls()[index]
    before = _counts()
    with_grad = call(True)
    assert type(with_grad.grad_fn).__name__ == f"{fn_cls.__name__}Backward"
    want = with_grad.detach()

    def refuse(*args):
        raise AssertionError(f"{name}: the Function ran without a "
                             f"gradient wanted")
    monkeypatch.setattr(fn_cls, "apply", refuse)
    plain = call(False)
    assert plain.grad_fn is None and torch.equal(plain, want)
    with torch.no_grad():
        off = call(True)
    assert off.grad_fn is None and torch.equal(off, want)
    assert _counts() == before         # the CPU path launches nothing


def test_needs_grad():
    """Grad mode on and an operand requiring a gradient; nothing else."""
    t = torch.ones(2, requires_grad=True)
    assert needs_grad(torch.ones(2), t)
    assert not needs_grad(torch.ones(2))
    assert not needs_grad()
    with torch.no_grad():
        assert not needs_grad(t)
    with torch.inference_mode():
        assert not needs_grad(torch.ones(2))
