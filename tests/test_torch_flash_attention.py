"""The port's flash-attention wrapper (``repro_torch.kernels
.flash_attention``) against the reference's Pallas kernel run in interpret
mode and its plain version, on the same numpy inputs, in the model layout
(B, S, H, D). On the CPU the wrapper runs the plain PyTorch version; the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_plain
from repro.models.layers import attention as ref_attn
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import attention as port_attn
from torch_parity import BF16_SPACING, EPS32, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

# name: (B, S, H, Hkv, D, causal, window)
CASES = {
    "causal_gqa": (2, 64, 4, 2, 64, True, None),
    "causal_gqa_d128": (1, 48, 28, 4, 128, True, None),
    "window": (2, 64, 4, 2, 64, True, 16),
    "window_noncausal": (1, 40, 4, 4, 64, False, 9),
    "noncausal": (2, 33, 4, 1, 64, False, None),
    "ragged_77": (1, 77, 8, 2, 64, True, None),
    "mha": (2, 24, 2, 2, 32, True, None),
    "s1": (3, 1, 4, 2, 64, True, None),
}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, S, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shp).astype(np.float32)
               for shp in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return tuple(a.astype(DTYPES[dtype]) for a in (q, k, v))


def _tol(v: np.ndarray, want: np.ndarray, dtype: str) -> np.ndarray:
    """Two fp32 evaluations of the same softmax-weighted sum (online over
    blocks against materialised) differ by roundoff in the scores, the
    exponentials and the sums: a few eps of max|v| per output; 64 eps of
    it leaves a wide margin. bf16 output adds one spacing of the value."""
    fp32 = 64 * EPS32 * float(np.abs(to_f32(v)).max())
    if dtype == "float32":
        return np.full(want.shape, fp32)
    return fp32 + BF16_SPACING * (np.abs(want) + fp32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference_pallas_kernel(case, dtype):
    B, S, H, Hkv, D, causal, window = CASES[case]
    q, k, v = _inputs(B, S, H, Hkv, D, dtype)
    want = to_f32(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, interpret=True))
    got = flash_attention(to_port(q), to_port(k), to_port(v), causal=causal,
                          window=window)
    assert got.shape == (B, S, H, D) and got.dtype == to_port(q).dtype
    assert (np.abs(to_f32(got) - want) <= _tol(v, want, dtype)).all()


@pytest.mark.parametrize("case", ["causal_gqa", "window", "noncausal"])
def test_plain_version_matches_reference_plain_version(case):
    B, S, H, Hkv, D, causal, window = CASES[case]
    q, k, v = _inputs(B, S, H, Hkv, D, "float32", seed=1)
    want = np.asarray(ref_plain(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, scale=0.3))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        scale=0.3).numpy()
    assert (np.abs(got - want) <= _tol(v, want, "float32")).all()


def test_seq_k_masks_the_tail_and_counts_no_launch_on_the_cpu():
    """Keys at or past ``seq_k`` take no weight: non-causal attention over
    a key tail of garbage equals attention over the true keys alone."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 20, 4, 2, 64,
                                                     "float32", seed=2))
    k_pad = torch.cat([k, 1e3 * torch.ones_like(k[:, :7])], dim=1)
    v_pad = torch.cat([v, 1e3 * torch.ones_like(v[:, :7])], dim=1)
    before = flash_attention.launches
    got = flash_attention(q, k_pad, v_pad, causal=False, seq_k=20)
    want = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="seq_k"):
        flash_attention(q, k, v, seq_k=21)


@pytest.mark.parametrize("case", ["causal_gqa", "window", "noncausal"])
def test_layer_naive_attention_and_band_mask_match_reference(case):
    """The attention layer's plain helpers: the band mask (with the last
    keys marked as padded slots by the 2**29 sentinel) is identical, and
    naive attention under it agrees within the fp32 tolerance."""
    B, S, H, Hkv, D, causal, window = CASES[case]
    q, k, v = _inputs(B, S, H, Hkv, D, "float32", seed=3)
    q_pos = np.arange(S)
    k_pos = np.where(q_pos < S - 3, q_pos, 2 ** 29)
    want_mask = ref_attn._band_mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                    causal, window)
    mask = port_attn._band_mask(torch.from_numpy(q_pos),
                                torch.from_numpy(k_pos), causal, window)
    assert (mask.numpy() == np.asarray(want_mask)).all()
    want = np.asarray(ref_attn.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), want_mask, 0.3))
    got = port_attn.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), mask, 0.3).numpy()
    assert (np.abs(got - want) <= _tol(v, want, "float32")).all()


def test_layer_init_kv_cache_matches_reference():
    want = ref_attn.init_kv_cache(2, 9, 4, 64, jnp.bfloat16)
    got = port_attn.init_kv_cache(2, 9, 4, 64, torch.bfloat16, "cpu")
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert not g.any()
