"""The rmsnorm kernel's gated entry (Mamba2's norm-then-gate,
``RMSNorm(x * silu(z)) * scale``) on the CPU: its plain twin
(``kernels.rmsnorm.ref.gated_rmsnorm_ref``) and the layer
(``models.layers.norms.gated_rmsnorm``, both backends) against the
reference's ``repro.models.layers.norms.gated_rmsnorm`` on the same numpy
inputs, with z contiguous and as a strided slice of a wider array (as the
Mamba2 block hands it in); the Mamba2 block's forward and decode on both
backends; and the launch plan of both entries (``ops._plan``, a pure
function of the shape) at the served models' widths. The CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against the plain twin.

Tolerances: float32 within 8 eps of the largest output (the same fp32
formula, summed in other orders); bfloat16 within one bf16 spacing of the
largest output (two roundings of nearby fp32 values).
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models.layers import norms as rnorms
from repro_torch.configs import registry as treg
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_ref
from repro_torch.models.layers import norms as tnorms
from repro_torch.models.layers import ssm as tssm
from torch_parity import BF16_SPACING, EPS32, to_f32, transformer_params_np
from torch_parity import one_thread  # noqa: F401 (autouse)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(rows, d, dtype, layout, seed=0):
    """x (rows, d) and z as numpy arrays for the reference and tensors for
    the port, scale (d,): z either contiguous or columns [d+8, 2d+8) of a
    (rows, 2d + 24) array, read in place by the port."""
    rng = np.random.default_rng(seed)
    cast = DTYPES[dtype]
    x = (2 * rng.standard_normal((rows, d)) + 0.5).astype(np.float32)
    wide = (4 * rng.standard_normal((rows, 2 * d + 24))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x, wide, s = x.astype(cast), wide.astype(cast), s.astype(cast)
    if layout == "strided":
        z_np = wide[:, d + 8:2 * d + 8]
        z_t = to_port(wide)[:, d + 8:2 * d + 8]
        assert z_t.stride() == (2 * d + 24, 1)
    else:
        z_np = np.ascontiguousarray(wide[:, :d])
        z_t = to_port(z_np)
    return x, z_np, s, to_port(x), z_t, to_port(s)


def _tol(want: np.ndarray, dtype: str) -> float:
    big = float(np.abs(want).max())
    return (8 * EPS32 if dtype == "float32" else BF16_SPACING) * big


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("d", [64, 200, 512])
@pytest.mark.parametrize("rows", [1, 2, 33])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gated_norm_matches_reference(dtype, rows, d, layout):
    x, z, s, tx, tz, ts = _inputs(rows, d, dtype, layout, seed=rows + d)
    want = to_f32(rnorms.gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                       jnp.asarray(s), 1e-6))
    tol = _tol(want, dtype)
    for got in (gated_rmsnorm_ref(tx, tz, ts, 1e-6),
                tnorms.gated_rmsnorm(tx, tz, ts, 1e-6),
                tnorms.gated_rmsnorm(tx, tz, ts, 1e-6, backend="ref")):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        assert np.abs(to_f32(got) - want).max() <= tol


def test_wrapper_counts_no_launch_on_the_cpu():
    x, z, s, tx, tz, ts = _inputs(5, 96, "float32", "strided", seed=3)
    before = ops.gated_rmsnorm.launches, ops.rmsnorm.launches
    got = ops.gated_rmsnorm(tx, tz, ts, 1e-5)
    assert torch.equal(got, gated_rmsnorm_ref(tx, tz, ts, 1e-5))
    assert (ops.gated_rmsnorm.launches, ops.rmsnorm.launches) == before


def _ssm_setup(dtype):
    """The smoke mamba2-2.7b's layer 0 (d_inner 512) with half its heads
    masked."""
    cr = rreg.get_smoke_config("mamba2-2.7b").replace(dtype=dtype)
    ct = treg.get_smoke_config("mamba2-2.7b").replace(dtype=dtype)
    tree = transformer_params_np(cr, 0)["runs"][0]["ssm"]
    lp = to_port({k: v[0] for k, v in tree.items()})
    hm = torch.zeros(cr.ssm_heads)
    hm[:cr.ssm_heads // 2] = 1.0
    return ct, lp, hm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_and_decode_backends_agree_on_the_cpu(dtype):
    """The Mamba2 block's forward (with the state it hands to decode) and
    one decode step give the same bits on both backends on the CPU, and
    neither launches a kernel."""
    ct, lp, hm = _ssm_setup(dtype)
    rng = np.random.default_rng(4)
    x = to_port(rng.standard_normal((2, 19, ct.d_model)).astype(np.float32)
                .astype(DTYPES[dtype]))
    launches = ops.gated_rmsnorm.launches
    outs = {}
    for backend in ("auto", "ref"):
        out, cache = tssm.ssm_forward(lp, ct, x[:, :18], head_mask=hm,
                                      return_state=True, backend=backend)
        step, new = tssm.ssm_decode(lp, ct, x[:, 18:], cache, head_mask=hm,
                                    backend=backend)
        outs[backend] = (out, step, new.conv, new.state)
    for a, b in zip(outs["auto"], outs["ref"]):
        assert torch.equal(a, b)
    assert ops.gated_rmsnorm.launches == launches


#: name: (rows, d, dtype, aligned, gated, the plan: vec, threads a row,
#: slots a lane)
PLANS = {
    "qwen2 prefill": (2048, 3584, BF16, True, False, (8, 64, 8)),
    "qwen2 prefill R2": (2000, 3584, BF16, True, False, (8, 64, 8)),
    "qwen2 decode 1": (1, 3584, BF16, True, False, (8, 256, 4)),
    "qwen2 decode 2": (2, 3584, BF16, True, False, (8, 256, 4)),
    "qwen2 fp32": (2048, 3584, F32, True, False, (4, 128, 8)),
    "mamba2 pre-norm": (2048, 2560, BF16, True, False, (8, 64, 6)),
    "zamba2 pre-norm": (2048, 2048, BF16, True, False, (8, 64, 4)),
    "narrow": (300, 1024, BF16, True, False, (8, 32, 4)),
    "mamba2 gated": (2048, 5120, BF16, True, True, (8, 256, 4)),
    "mamba2 gated decode": (1, 5120, BF16, True, True, (8, 256, 4)),
    "zamba2 gated": (2048, 4096, BF16, True, True, (8, 128, 4)),
    "gated fp32": (1000, 5120, F32, True, True, (4, 256, 6)),
    "ragged d": (3, 77, BF16, True, False, (1, 32, 4)),
    "ragged gated": (33, 77, BF16, True, True, (1, 32, 4)),
    "unaligned": (2048, 3584, BF16, False, False, (1, 64, 8)),
    "unaligned gated": (300, 5120, BF16, False, True, (1, 256, 4)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_pins_the_route(name):
    rows, d, dtype, aligned, gated, want = PLANS[name]
    assert ops._plan(rows, d, dtype, aligned, gated) == want


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_covers_every_column_within_the_instances(dtype, gated):
    """Every width up to the kernel's limit gets a plan whose lanes hold the
    whole row (threads a row x slots a lane x slot width >= d) in an
    instance the kernel has; wider rows raise."""
    w = ops._slot(dtype)
    most = ops.GATED_MOST[dtype] if gated else ops.LANE_SLOTS[-1]
    widest = ops.ROW_THREADS[-1] * most * w
    for d in [*range(1, 300, 7), 2048, 2560, 3584, 4096, 5120, 8192,
              18432 if widest >= 18432 else widest, widest]:
        for rows in (1, 2, 3, 2048):
            for aligned in (True, False):
                vec, tpr, nv = ops._plan(rows, d, dtype, aligned, gated)
                assert vec == (w if aligned and d % w == 0 else 1)
                assert tpr in ops.ROW_THREADS and nv in ops.LANE_SLOTS
                assert nv <= most and tpr * nv * w >= d
                assert tpr == 256 or rows > ops.DECODE_ROWS
    with pytest.raises(ValueError, match="wider"):
        ops._plan(2048, widest + 1, dtype, True, gated)


def test_row_stride_reads_views_in_place():
    base = torch.zeros(2, 5, 40)
    assert ops._row_stride(base) == 40
    assert ops._row_stride(base[..., 8:24]) == 40         # z in the block
    assert ops._row_stride(base[:, 0, 8:24][:, None]) == 200  # z in decode
    assert ops._row_stride(base[:1, :1]) == 40            # one row
    assert ops._row_stride(base[:, :3]) is None           # rows 2 strides
    assert ops._row_stride(base[..., ::2]) is None        # columns strided
    assert ops._row_stride(base.transpose(1, 2)) is None


def test_gated_entries_take_z_and_row_strides():
    """The gated C entries bind x, z, scale, y; rows, d and the two row
    strides; eps; the plan — each against its own C parameter."""
    src = (build.CSRC_DIR / "rmsnorm.cu").read_text()
    for dtype in (F32, BF16):
        symbol = ops._ENTRIES[True, dtype]
        assert ops._SIGNATURES[symbol] is ops._GATED_ARGTYPES
        params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
        names = [p.split()[-1].lstrip("*")
                 for p in params.group(1).split(",")]
        assert names == ["x", "z", "scale", "y", "rows", "d", "ldx", "ldz",
                         "eps", "vec", "tpr", "nv", "stream"]
        assert ops._SIGNATURES[ops._ENTRIES[False, dtype]] is ops._ARGTYPES


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_gated_norm_matches_reference_and_its_vjp(dtype, m):
    """The gated norm of rows whose 200 columns are split over ``m`` ranks
    in contiguous blocks (``blocks``: 67, 67, 66 at 3), z strided, run rank
    after rank (``SequentialRanks``): each rank's row sums of g²
    all-reduced, then its columns normalized
    (``ops.split_gated_rmsnorm``, both backends of the layer's). The
    ranks' outputs joined match the reference's ``gated_rmsnorm`` within
    the whole row's tolerance; in float32 the gradients (each rank's dx,
    dz and dscale of its columns, the backward's row sums of u·gw
    all-reduced) joined match ``jax.vjp`` of it within ``GRAD_RTOL32`` of
    each gradient's largest entry."""
    import jax
    from repro_torch.sharding.tensor_parallel import SequentialRanks, blocks
    from torch_parity import GRAD_RTOL32
    d = 200
    x, z, s, tx, tz, ts = _inputs(33, d, dtype, "strided", seed=m)
    want = to_f32(rnorms.gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                       jnp.asarray(s), 1e-6))
    cols = blocks(d, m)
    grad = dtype == "float32"
    gy = np.random.default_rng(7).standard_normal((33, d)).astype(np.float32)

    def share(axis, backend):
        lo, hi = cols[axis.rank]
        xs, zs, ss = (t[..., lo:hi].detach().requires_grad_(grad)
                      for t in (tx, tz, ts))
        out = tnorms.split_gated_rmsnorm(xs, zs, ss, 1e-6, axis, d,
                                         backend=backend)
        if not grad:
            return out, None
        return out, torch.autograd.grad(
            out, (xs, zs, ss), torch.from_numpy(gy[:, lo:hi]))
    for backend in ("auto", "ref"):
        ranks = SequentialRanks(m)
        got = ranks.run([lambda a=a: share(a, backend)
                         for a in ranks.axes()])
        out = torch.cat([o for o, _ in got], dim=-1)
        assert out.dtype == tx.dtype
        assert np.abs(to_f32(out) - want).max() <= _tol(want, dtype)
        if not grad:
            continue
        _, vjp = jax.vjp(lambda a, b, c: rnorms.gated_rmsnorm(a, b, c, 1e-6),
                         jnp.asarray(x), jnp.asarray(z), jnp.asarray(s))
        for i, w in enumerate(vjp(jnp.asarray(gy))):
            g = torch.cat([gr[i] for _, gr in got], dim=-1).numpy()
            w = np.asarray(w)
            assert np.abs(g - w).max() <= GRAD_RTOL32 * np.abs(w).max()


def test_split_entries_count_no_launch_on_the_cpu():
    """On CPU tensors the split entries' wrappers run their plain twins
    (``gated_sumsq_ref``, ``gated_rmsnorm_stat_ref``) and count no
    launch; on one rank the pair is the whole gated norm."""
    from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_stat_ref,
                                                 gated_sumsq_ref)
    _, _, _, tx, tz, ts = _inputs(5, 64, "float32", "strided")
    ops.gated_sumsq.launches = ops.gated_rmsnorm_stat.launches = 0
    ss = ops.gated_sumsq(tx, tz)
    assert torch.equal(ss, gated_sumsq_ref(tx, tz)) and ss.shape == (5,)
    y = ops.gated_rmsnorm_stat(tx, tz, ts, ss, 64, 1e-6)
    assert torch.equal(y, gated_rmsnorm_stat_ref(tx, tz, ts, ss, 64, 1e-6))
    assert ops.gated_sumsq.launches == ops.gated_rmsnorm_stat.launches == 0
    want = gated_rmsnorm_ref(tx, tz, ts, 1e-6)
    assert torch.allclose(y, want, rtol=8 * EPS32, atol=0)
