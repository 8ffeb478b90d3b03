"""``repro_torch.optim`` against the JAX package's ``repro.optim``: the
learning-rate schedules over a range of steps, and SGD-momentum and AdamW
updates on shared parameters and gradients (numpy arrays handed to both),
the AdamW global-norm clip active and inactive, fp32 and bf16 moments."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ropt
from repro_torch import optim as topt
from torch_parity import EPS32, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

STEPS = list(range(0, 200, 7)) + [19, 20, 21, 39, 40, 41, 199]


def _schedules(mod):
    return {"constant": mod.constant(3e-3),
            "step_lr": mod.step_lr(0.01, 0.1, 2, steps_per_epoch=3),
            "step_lr_paper": mod.step_lr(0.01, 0.1, 20, steps_per_epoch=7),
            "cosine_warmup": mod.cosine_warmup(1e-3, 10, 150, floor=0.1),
            "cosine_no_warmup": mod.cosine_warmup(2e-4, 0, 50)}


#: (steps_per_epoch, step_size) of the step_lr schedules above
_STEP_LR = {"step_lr": (3, 2), "step_lr_paper": (7, 20)}


@pytest.mark.parametrize("name", sorted(_schedules(ropt)))
def test_schedule_matches_reference(name):
    """Both compute the rate in float32; the cosine may round differently
    in the last place (4 float32 ulp relative). For StepLR's gamma**n the
    reference multiplies by squaring (up to 2·log2(n) + 2 roundings) where
    the port rounds the power once, so 2·ceil(log2(n+1)) + 4 ulp."""
    r, t = _schedules(ropt)[name], _schedules(topt)[name]
    for step in STEPS:
        want = np.float32(r(jnp.int32(step)))
        got = t(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        ulps = 4
        if name in _STEP_LR:
            spe, size = _STEP_LR[name]
            ulps += 2 * int(np.ceil(np.log2(step // spe // size + 1)))
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=ulps * EPS32, atol=0,
                                   err_msg=f"{name} step {step}")


def _tree(rng, scale=1.0):
    return {"l0": {"w": scale * rng.standard_normal((3, 3, 3, 8)),
                   "b": scale * rng.standard_normal(8)},
            "l3": {"w": scale * rng.standard_normal((72, 10)),
                   "b": scale * rng.standard_normal(10)}}


def _f32_tree(tree):
    return {k: {n: np.asarray(a, np.float32) for n, a in v.items()}
            for k, v in tree.items()}


def _run(mod, name, params, grads_seq, as_leaf, **kw):
    opt = mod.make_optimizer(name, mod.step_lr(0.05, 0.5, 1,
                                               steps_per_epoch=2), **kw)
    p = {k: {n: as_leaf(a) for n, a in v.items()} for k, v in params.items()}
    state = opt.init(p)
    for g in grads_seq:
        gl = {k: {n: as_leaf(a) for n, a in v.items()} for k, v in g.items()}
        p, state = opt.update(gl, state, p)
    return p, state


def _leaves(tree):
    return [to_f32(tree[k][n]) for k in sorted(tree) for n in sorted(tree[k])]


def _assert_trees_close(got, want, ulps: float):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ulps * EPS32 * max(1.0,
                                                           np.abs(w).max()))


def test_sgd_momentum_steps_match_reference():
    """Five updates (the rate halves every second step) with momentum 0.9
    and weight decay: the reference's elementwise float32 arithmetic in
    its order, so parameters and momentum agree to a few roundings (8 ulp
    of the largest entry: XLA may fuse a multiply-add the port rounds
    twice)."""
    rng = np.random.default_rng(0)
    params = _f32_tree(_tree(rng))
    grads = [_f32_tree(_tree(rng, 0.3)) for _ in range(5)]
    kw = dict(momentum=0.9, weight_decay=1e-3)
    pr, sr = _run(ropt, "sgd", params, grads, jnp.asarray, **kw)
    pt, st = _run(topt, "sgd", params, grads, torch.from_numpy, **kw)
    assert st["step"] == int(sr["step"]) == 5
    _assert_trees_close(pt, pr, 8)
    _assert_trees_close(st["mom"], sr["mom"], 8)


@pytest.mark.parametrize("grad_scale,clip", [(5.0, 1.0), (1e-3, 1.0),
                                             (5.0, 0.0)],
                         ids=["clip_active", "clip_inactive", "no_clip"])
def test_adamw_steps_match_reference(grad_scale, clip):
    """Four AdamW updates with weight decay, bias correction at step+1:
    with gradients whose global norm exceeds the clip (scaled down), lies
    under it (left alone), and with the clip off. The global norm sums
    the leaves in another order; m / sqrt(v) then divides two values each
    a few roundings off, so 64 ulp of the largest entry."""
    rng = np.random.default_rng(1)
    params = _f32_tree(_tree(rng))
    grads = [_f32_tree(_tree(rng, grad_scale)) for _ in range(4)]
    kw = dict(weight_decay=1e-2, grad_clip=clip)
    pr, sr = _run(ropt, "adamw", params, grads, jnp.asarray, **kw)
    pt, st = _run(topt, "adamw", params, grads, torch.from_numpy, **kw)
    assert st["step"] == int(sr["step"]) == 4
    _assert_trees_close(pt, pr, 64)
    _assert_trees_close(st["m"], sr["m"], 64)
    _assert_trees_close(st["v"], sr["v"], 64)
    if clip:
        norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                           for a in _leaves(grads[0])))
        assert (norm > clip) == (grad_scale > 1)


def test_adamw_bf16_moments_match_reference():
    """Moments held in bfloat16 (``moment_dtype``): both round the float32
    moment to bf16 to nearest-even; a moment a few float32 roundings from
    a rounding boundary may land one bf16 spacing apart, so the moments
    agree to one bf16 spacing and the parameters to what one spacing of
    m/sqrt(v) moves them: 3 steps x lr 0.05 x 2^-7 x |m/sqrt(v)| (at most
    2 here)."""
    rng = np.random.default_rng(2)
    params = _f32_tree(_tree(rng))
    grads = [_f32_tree(_tree(rng, 0.5)) for _ in range(3)]
    pr, sr = _run(ropt, "adamw", params, grads, jnp.asarray,
                  moment_dtype=jnp.bfloat16)
    pt, st = _run(topt, "adamw", params, grads, torch.from_numpy,
                  moment_dtype=torch.bfloat16)
    for key in ("m", "v"):
        for g, w in zip(_leaves(st[key]), _leaves(sr[key])):
            assert st[key]["l0"]["w"].dtype == torch.bfloat16
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-30)
    for g, w in zip(_leaves(pt), _leaves(pr)):
        np.testing.assert_allclose(g, w, rtol=0, atol=3 * 0.05 * 2.0 ** -6)


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_adamw_slabs_change_no_bit(dtype, moments, monkeypatch):
    """Three AdamW steps (clip and weight decay on) with leaves walked in
    slabs of at most 1,000 entries (``optimizers.SLAB``: a 3-d stacked
    leaf, a long 1-d one, a list leaf, a scalar) equal the steps with each
    leaf whole, bit for bit: the update is elementwise."""
    from repro_torch.optim import optimizers
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    params = {"w": torch.randn(7, 33, 17, generator=gen).to(dt),
              "e": torch.randn(3001, generator=gen).to(dt),
              "s": torch.randn((), generator=gen).to(dt),
              "b": [torch.randn(5, 401, generator=gen).to(dt)]}
    grads = optimizers.tree_map(lambda p: 3 * p, params)
    out = {}
    for slab in (1000, optimizers.SLAB):
        monkeypatch.setattr(optimizers, "SLAB", slab)
        opt = topt.adamw(topt.constant(1e-3), weight_decay=0.1,
                         moment_dtype=getattr(torch, moments))
        p, state = params, opt.init(params)
        for _ in range(3):
            p, state = opt.update(grads, state, p)
        out[slab] = optimizers.tree_leaves((p, state["m"], state["v"]))
    small, whole = out.values()
    assert len(small) == len(whole) == 12
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(small, whole))
