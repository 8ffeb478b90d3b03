"""The head-atomic chunked attention (``repro_torch.models.layers.
attention.chunked_attention_ha``) and its selection in ``gqa_forward``
against the reference's on the same numpy inputs: Qwen2-7B's 28 query
heads over 4 KV heads (groups of 7), causal, windowed and non-causal,
keys in blocks of 8 with a ragged last block (the padded-key path), in
float32 and bf16. The reference runs with its Pallas dispatch off, its
default (the branch that selects the head-atomic path).

Tolerances (``torch_parity.stack_tol``): float32 within 64 eps of the
largest entry, bf16 within 4 bf16 spacings of it.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.kernels import dispatch
from repro.models.layers import attention as ratt
from repro_torch.configs import registry as treg
from repro_torch.interop import transformer_params_from_reference
from repro_torch.models.layers import attention as tatt
from torch_parity import stack_tol, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

DTYPES = ["float32", "bfloat16"]
#: (causal, window)
MASKS = {"causal": (True, None), "window": (True, 5),
         "noncausal": (False, None)}


def _close(got, want, dtype):
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= stack_tol(want, dtype)


def _arrays(dtype, shapes, seed=0):
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    return [rng.standard_normal(s).astype(np.float32).astype(dt)
            for s in shapes]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", sorted(MASKS))
@pytest.mark.parametrize("S", [16, 21])
def test_chunked_attention_ha_matches_reference(S, variant, dtype):
    """28/4 heads of 16 at B = 2: S = 16 is two whole blocks of 8, S = 21
    three with the last padded by 3 (sentinel positions); the port's
    float32 result also equals its own grouped ``chunked_attention``."""
    causal, window = MASKS[variant]
    B, H, Hkv, D = 2, 28, 4, 16
    q, k, v = _arrays(dtype, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    scale = D ** -0.5
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = ratt.chunked_attention_ha(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(pos), jnp.asarray(pos),
                                     causal, window, scale, block_kv=8)
    tq, tk, tv = (transformer_params_from_reference(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    got = tatt.chunked_attention_ha(tq, tk, tv, tpos, tpos, causal, window,
                                    scale, block_kv=8)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    if dtype == "float32":
        _close(got, tatt.chunked_attention(tq, tk, tv, tpos, tpos, causal,
                                           window, scale, block_kv=8),
               dtype)


def _gqa_params(cfg, dtype, seed=1):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    names = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
             "bq": (qd,), "bk": (kvd,), "bv": (kvd,)}
    arrays = _arrays(dtype, list(names.values()), seed)
    return {n: a / np.sqrt(s[0]).astype(a.dtype) if len(s) == 2 else a
            for (n, s), a in zip(names.items(), arrays)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_gqa_forward_selects_the_head_atomic_path(dtype, masked,
                                                  monkeypatch):
    """Qwen2-7B's smoke attention (4/2 heads of 64, QKV biases) with
    ``attn_head_atomic`` set and ``naive_attn_max`` 8: a 20-token forward
    on the plain branch goes through ``chunked_attention_ha`` in both
    packages, and the port's output and (k, v) equal the reference's."""
    over = dict(dtype=dtype, attn_head_atomic=True, naive_attn_max=8)
    rcfg = rreg.get_smoke_config("qwen2-7b").replace(**over)
    tcfg = treg.get_smoke_config("qwen2-7b").replace(**over)
    pn = _gqa_params(rcfg, dtype)
    (x,) = _arrays(dtype, [(2, 20, rcfg.d_model)], seed=2)
    hm = (np.array([1.0, 0.0, 1.0, 1.0], np.float32) if masked else None)
    assert not dispatch.enabled()
    want, (wk, wv) = ratt.gqa_forward(
        {n: jnp.asarray(a) for n, a in pn.items()}, rcfg, jnp.asarray(x),
        None, head_mask=None if hm is None else jnp.asarray(hm))
    calls = []
    real = tatt.chunked_attention_ha
    monkeypatch.setattr(tatt, "chunked_attention_ha",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, (gk, gv) = tatt.gqa_forward(
        transformer_params_from_reference(pn), tcfg,
        transformer_params_from_reference(x), None,
        head_mask=None if hm is None else torch.from_numpy(hm),
        backend="ref")
    assert calls == [1]
    _close(got, want, dtype)
    _close(gk, wk, dtype)
    _close(gv, wv, dtype)


def test_head_atomic_path_only_where_selected(monkeypatch):
    """Unset, at or under ``naive_attn_max`` tokens, or on the kernel
    branch, ``gqa_forward`` never calls ``chunked_attention_ha``; no
    registry config sets the flag."""
    assert not any(treg.get_config(a).attn_head_atomic or
                   treg.get_smoke_config(a).attn_head_atomic
                   for a in treg.ARCH_IDS)
    monkeypatch.setattr(tatt, "chunked_attention_ha",
                        lambda *a, **k: pytest.fail("head-atomic path"))
    base = treg.get_smoke_config("qwen2-7b").replace(dtype="float32")
    pt = transformer_params_from_reference(_gqa_params(base, "float32"))
    x = torch.from_numpy(_arrays("float32", [(1, 20, base.d_model)])[0])
    for cfg, backend in ((base.replace(naive_attn_max=8), "ref"),
                         (base.replace(attn_head_atomic=True), "ref"),
                         (base.replace(attn_head_atomic=True,
                                       naive_attn_max=8), "auto")):
        tatt.gqa_forward(pt, cfg, x, None, backend=backend)
