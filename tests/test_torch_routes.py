"""How the port's kernels are chosen and what their numerics may do,
held on the CPU (the CUDA kernels run only on the card, where
``chip_smoke.py`` holds each against its plain version):

- ``masked_matmul``'s route, a pure function of B's dtype and the shape, at
  the pruned Qwen2-7B's real widths: the bf16 decode GEMV for 1 and 2 rows,
  the wgmma/TMA tiles above, the CUDA-core tiles for K or N not a multiple
  of 8; float32 products of every shape on the split-K routes; at every
  GEMM of AlexNet, full and compacted: the float32 / int8-code split-K GEMV
  for the dense layers and the split-K cluster tiles for the convs, with
  the plan the host gives each; every routed symbol an ``extern "C"`` entry
  of the source, with its signature;
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
from repro_torch.kernels.masked_matmul import ops
from torch_parity import flash_bf16_tolerance, p_in_bf16_attention, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

#: Qwen2-7B's FFN up/gate product: K = d_model, N = d_ff
K, N = 3584, 18944
TILES, GEMV = ops._ENTRIES["tiles"], ops._ENTRIES["gemv"]
CORES_BF16 = ops._ENTRIES["cuda_cores_bf16"]
F32_GEMV, F32_SPLITK = ops._ENTRIES["f32_gemv"], ops._ENTRIES["f32_splitk"]
Q8_GEMV, Q8_SPLITK = ops._ENTRIES["q8_gemv"], ops._ENTRIES["q8_splitk"]
#: AlexNet's compacted dense14: the float32 GEMV / split-K crossover shape
D14_K, D14_N = 4608, 2048

# name: (dtype, M, K, N, aligned, expected entry)
ROUTES = {
    "decode_r1": (torch.bfloat16, 1, K, N, True, GEMV),
    "decode_r2": (torch.bfloat16, 2, K, N, True, GEMV),
    "first_tile_row": (torch.bfloat16, 3, K, N, True, TILES),
    "m8": (torch.bfloat16, 8, K, N, True, TILES),
    "m9": (torch.bfloat16, 9, K, N, True, TILES),
    "prefill_r2": (torch.bfloat16, 2000, K, N, True, TILES),
    "prefill_r1": (torch.bfloat16, 2048, K, N, True, TILES),
    "fp32_prefill": (torch.float32, 2048, K, N, True, F32_SPLITK),
    "fp32_decode": (torch.float32, 1, K, N, True, F32_GEMV),
    "fp32_gemv_last_row": (torch.float32, ops.GEMV_F32_MAX_ROWS, D14_K,
                           D14_N, True, F32_GEMV),
    "fp32_splitk_first_row": (torch.float32, ops.GEMV_F32_MAX_ROWS + 1,
                              D14_K, D14_N, True, F32_SPLITK),
    "fp32_gemv_k_too_deep": (torch.float32, 1,
                             8 * ops.GEMV_F32_MAX_KPER + 8, D14_N, True,
                             F32_SPLITK),
    "fp32_conv": (torch.float32, 169, 1728, 128, True, F32_SPLITK),
    "q8_decode": (torch.uint8, 1, D14_K, D14_N, True, Q8_GEMV),
    "q8_conv": (torch.uint8, 729, 800, 96, True, Q8_SPLITK),
    "q8_large": (torch.uint8, 2048, K, N, True, Q8_SPLITK),
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


#: each entry's C parameters: the shared ones; the float32 routes add the
#: host's plan; the code routes take B as codes with their scale and zero
SHARED = ["A", "B", "mask", "C", "M", "N", "K", "stream"]
PLANNED = ["A", "B", "mask", "C", "M", "N", "K", "tile", "split", "vec",
           "stream"]
CODES = ["A", "codes", "scale", "zero", "mask", "C", "M", "N", "K", "tile",
         "split", "vec", "stream"]
PARAMS = {CORES_BF16: SHARED, TILES: SHARED,
          GEMV: SHARED, F32_GEMV: PLANNED, F32_SPLITK: PLANNED,
          Q8_GEMV: CODES, Q8_SPLITK: CODES}


def test_every_routed_symbol_is_a_c_entry_with_the_shared_signature():
    """Every entry is routed to and defined in the source, with the
    parameters of its group (the ctypes types are held in
    ``test_torch_kernel_sources.py``)."""
    src = (build.CSRC_DIR / "masked_matmul.cu").read_text()
    entries = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', src)}
    routed = {ops._route(*ROUTES[c][:5]) for c in ROUTES}
    assert routed == set(ops._ENTRIES.values()) == set(entries) == set(PARAMS)
    for symbol, params in entries.items():
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert names == PARAMS[symbol], symbol


def test_route_launch_counters_cover_every_entry():
    """``route_launches`` has one counter per entry, beside the total."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    assert set(masked_matmul.route_launches) == set(ops._ENTRIES.values())


def _alexnet_gemms():
    """name -> (M, K, N) of every conv (im2col) and dense GEMM of one
    batch-1 request through full-width AlexNet, full and with half of every
    prunable layer's channels compacted away (the shapes ``chip_smoke.py``
    drives on the card)."""
    from repro_torch.models.cnn import (alexnet_config, compact_cnn_config,
                                        layer_shapes, prunable_layers)
    full = alexnet_config(38)
    shapes = layer_shapes(full)
    halves = {i: np.arange(shapes[i][0]) < shapes[i][0] // 2
              for i in prunable_layers(full)}
    out = {}
    for label, cfg in (("full", full), ("compact",
                                        compact_cnn_config(full, halves))):
        shp, c_in = layer_shapes(cfg), cfg.input_channels
        for i, spec in enumerate(cfg.layers):
            if spec.kind == "conv":
                c, h, w = shp[i]
                out[f"conv{i} {label}"] = (h * w, c_in * spec.kernel ** 2, c)
                c_in = c
            elif spec.kind == "dense":
                out[f"dense{i} {label}"] = (1, shp[i - 1][0], spec.features)
    return out


ALEXNET = _alexnet_gemms()


@pytest.mark.parametrize("codes", [False, True], ids=["float32", "codes"])
@pytest.mark.parametrize("gemm", sorted(ALEXNET))
def test_alexnet_gemm_takes_its_split_k_route_and_plan(gemm, codes):
    """A dense layer (M = 1) goes to the split-K GEMV: one row of A a
    block, K split over at most 8 blocks of a cluster, 16-byte reads where
    N allows (4 floats, 16 codes; dense18's N = 38 does not). A conv goes
    to the split-K tiles: 32 or 64 rows by 32 columns, tiles x split at
    least the 132 SMs, a split of at most 8 with at least 4 slices of K a
    block, 4-element copies of B (every conv's N is a multiple of 4)."""
    M, Kd, Nd = ALEXNET[gemm]
    entry, (tile, split, vec) = ops._plan(torch.uint8 if codes
                                          else torch.float32, M, Kd, Nd)
    assert 1 <= split <= ops.CLUSTER_MAX
    if gemm.startswith("dense"):
        assert entry == (Q8_GEMV if codes else F32_GEMV)
        assert tile == 1
        wide = 16 if codes else 4
        assert vec == (wide if Nd % wide == 0 else 1)
        assert -(-Kd // split) <= ops.GEMV_F32_MAX_KPER
    else:
        assert entry == (Q8_SPLITK if codes else F32_SPLITK)
        assert tile in (32, 64) and vec == 4
        tiles = -(-M // tile) * -(-Nd // ops.SPLITK_BN)
        assert tiles * split >= ops.SMS
        assert -(-Kd // ops.SPLITK_BK) // split >= ops.SPLITK_MIN_SLICES


@pytest.mark.parametrize("codes", [False, True], ids=["float32", "codes"])
def test_gemv_rows_and_vector_widths(codes):
    """The GEMV's rows of A a block (1, 2, then 4) and its B reads: 16
    bytes (4 floats, 16 codes) when N is a multiple of that and B is
    16-byte aligned, else one element."""
    wide = 16 if codes else 4
    rows = [ops._gemv_f32_plan(codes, m, D14_K, D14_N, True)[0]
            for m in range(1, ops.GEMV_F32_MAX_ROWS + 1)]
    assert rows == [1, 2] + [4] * (ops.GEMV_F32_MAX_ROWS - 2)
    assert ops._gemv_f32_plan(codes, 1, D14_K, D14_N, True)[2] == wide
    assert ops._gemv_f32_plan(codes, 1, D14_K, D14_N, False)[2] == 1
    assert ops._gemv_f32_plan(codes, 1, D14_K, 38, True)[2] == 1
    assert ops._gemv_f32_plan(codes, 1, D14_K, wide * 3, True)[2] == wide


def test_f32_gemv_and_splitk_meet_at_the_measured_crossover():
    """At dense14's shape the float32 GEMV takes exactly the rows up to
    ``GEMV_F32_MAX_ROWS``; the row after it is the split-K tiles'."""
    rows = [m for m in range(1, 65)
            if ops._route(torch.float32, m, D14_K, D14_N) == F32_GEMV]
    assert rows == list(range(1, ops.GEMV_F32_MAX_ROWS + 1))


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
    got = to_f32(p_in_bf16_attention(to_port(q), to_port(k), to_port(v),
                                      causal, window))
    tol = flash_bf16_tolerance(to_f32(v), want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all()
