"""How the port's bf16 kernels are chosen and what their numerics may do,
held on the CPU (the CUDA kernels run only on the card, where
``chip_smoke.py`` holds each against its plain version):

- ``masked_matmul``'s route, a pure function of dtype and shape, at the
  pruned Qwen2-7B's real widths: the decode GEMV for 1 and 2 rows, the
  wgmma/TMA tiles above, the CUDA-core tiles for float32 and for K or N not
  a multiple of 8; every routed symbol an ``extern "C"`` entry of the source;
- the bf16 ``flash_attention`` kernel's one numeric change, P rounded to
  bf16 before P·V, emulated here in plain PyTorch and held against the
  reference's Pallas kernel (interpret mode) within the tolerance that
  ``chip_smoke.py`` holds the kernel to."""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.kernels.masked_matmul import ops
from torch_parity import BF16_SPACING, EPS32, to_f32

#: Qwen2-7B's FFN up/gate product: K = d_model, N = d_ff
K, N = 3584, 18944
TILES, GEMV = ops._ENTRIES["tiles"], ops._ENTRIES["gemv"]
CORES_F32, CORES_BF16 = (ops._ENTRIES["cuda_cores_f32"],
                         ops._ENTRIES["cuda_cores_bf16"])

# name: (dtype, M, K, N, aligned, expected entry)
ROUTES = {
    "decode_r1": (torch.bfloat16, 1, K, N, True, GEMV),
    "decode_r2": (torch.bfloat16, 2, K, N, True, GEMV),
    "first_tile_row": (torch.bfloat16, 3, K, N, True, TILES),
    "m8": (torch.bfloat16, 8, K, N, True, TILES),
    "m9": (torch.bfloat16, 9, K, N, True, TILES),
    "prefill_r2": (torch.bfloat16, 2000, K, N, True, TILES),
    "prefill_r1": (torch.bfloat16, 2048, K, N, True, TILES),
    "fp32_prefill": (torch.float32, 2048, K, N, True, CORES_F32),
    "fp32_decode": (torch.float32, 1, K, N, True, CORES_F32),
    "k_not_8": (torch.bfloat16, 2048, K - 4, N, True, CORES_BF16),
    "n_not_8": (torch.bfloat16, 1, K, N - 2, True, CORES_BF16),
    "ragged_77x29x45": (torch.bfloat16, 77, 29, 45, True, CORES_BF16),
    "unaligned": (torch.bfloat16, 2048, K, N, False, CORES_BF16),
    "gemv_k_too_deep": (torch.bfloat16, 1, ops.GEMV_MAX_K + 8, N, True,
                        TILES),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_picks_the_entry_for_dtype_and_shape(case):
    dtype, M, k, n, aligned, want = ROUTES[case]
    assert ops._route(dtype, M, k, n, aligned) == want


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._route(torch.float16, 1, K, N)


def test_gemv_and_tiles_meet_at_the_measured_crossover():
    """The GEMV takes exactly the rows up to ``GEMV_MAX_ROWS``; the row
    after it is the tiles'."""
    rows = [m for m in range(1, 65) if ops._route(torch.bfloat16, m, K, N)
            == GEMV]
    assert rows == list(range(1, ops.GEMV_MAX_ROWS + 1))


def test_every_routed_symbol_is_a_c_entry_with_the_shared_signature():
    src = (build.CSRC_DIR / "masked_matmul.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', src)}
    routed = {ops._route(*ROUTES[c][:5]) for c in ROUTES}
    assert routed == set(ops._ENTRIES.values()) == set(entries)
    for symbol, params in entries.items():
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert names == ["A", "B", "mask", "C", "M", "N", "K", "stream"], \
            symbol


def test_route_launch_counters_cover_every_entry():
    """``route_launches`` has one counter per entry, beside the total."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    assert set(masked_matmul.route_launches) == set(ops._ENTRIES.values())


# (B, S, H, Hkv, D, causal, window), the flash tests' shapes
FLASH_CASES = {
    "causal_gqa": (2, 64, 4, 2, 64, True, None),
    "causal_gqa_d128": (1, 48, 28, 4, 128, True, None),
    "window": (2, 64, 4, 2, 64, True, 16),
    "window_noncausal": (1, 40, 4, 4, 64, False, 9),
    "noncausal": (2, 33, 4, 1, 64, False, None),
    "ragged_77": (1, 77, 8, 2, 64, True, None),
    "mha": (2, 24, 2, 2, 32, True, None),
    "s1": (3, 1, 4, 2, 64, True, None),
}


def _p_in_bf16_attention(q, k, v, causal, window):
    """Plain attention as the bf16 kernel rounds it: fp32 scores scaled
    after Q·Kᵀ, NEG_INF masks, fp32 softmax numerator P and denominator l,
    P rounded to bf16 before P·V, the fp32 sum divided by max(l, 1e-37) and
    rounded to bf16 once."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * D ** -0.5
    d = torch.arange(S)[:, None] - torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p16 = p.to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p16 / l.clamp_min(1e-37),
                       v.float())
    return out.reshape(B, S, H, D).to(torch.bfloat16)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_p_in_bf16_stays_within_the_stated_flash_tolerance(case):
    """Rounding each P entry to bf16 moves it by at most 2⁻⁸ of itself, so
    an output by at most 2⁻⁸·max|v|: the bf16 tolerance is 64·eps32·max|v|
    + 2⁻⁸·max|v|, plus one bf16 spacing of the value."""
    B, S, H, Hkv, D, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shp).astype(np.float32).astype(
        jnp.bfloat16) for shp in ((B, S, H, D), (B, S, Hkv, D),
                                  (B, S, Hkv, D)))
    want = to_f32(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, interpret=True))
    got = to_f32(_p_in_bf16_attention(to_port(q), to_port(k), to_port(v),
                                      causal, window))
    vmax = float(np.abs(to_f32(v)).max())
    fp = (64 * EPS32 + 2.0 ** -8) * vmax
    tol = fp + BF16_SPACING * (np.abs(want) + fp)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all()
