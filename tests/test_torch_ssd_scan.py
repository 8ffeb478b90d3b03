"""The port's SSD scan wrapper (``repro_torch.kernels.ssd_scan``) against
the reference's Pallas kernel run in interpret mode and its plain version
(``ssd_ref``, the model's ``ssd_chunked``), on the same numpy inputs, y and
final state. On the CPU the wrapper runs the plain PyTorch version; the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.

Tolerances (``torch_parity.ssd_tolerance``): two float32 evaluations of
the scan differ by at most (N + Q + n_chunks + 2·max|cs|)·eps of the sum
of the terms' magnitudes, per element; a bf16 y adds one bf16 spacing of
the value.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref
from torch_parity import BF16_SPACING, ssd_inputs, ssd_tolerance, to_f32

# name: (B, S, H, G, P, N, chunk)
CASES = {
    "sweep_16": (2, 64, 4, 1, 16, 32, 16),       # the reference's sweep
    "sweep_ragged": (1, 100, 4, 2, 32, 16, 32),
    "sweep_g8": (2, 128, 8, 8, 16, 16, 64),
    "groups_2": (1, 96, 8, 2, 32, 32, 32),
    "short_20": (2, 20, 4, 1, 16, 32, 32),       # S < chunk
    "s1": (2, 1, 4, 1, 16, 16, 32),
    "ragged_77": (1, 77, 4, 1, 16, 32, 32),
    "mamba2_heads": (1, 300, 4, 1, 64, 128, 256),
}


def _masks(H, seed=1):
    """None (every head) or a random half of the heads pruned."""
    m = np.zeros(H, np.float32)
    m[np.random.default_rng(seed).permutation(H)[:H // 2]] = 1.0
    return {"all": None, "half": m}


def _ok(got, want, tol):
    return bool((np.abs(to_f32(got) - to_f32(want)) <= tol).all())


@pytest.mark.parametrize("masked", ["all", "half"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference_pallas_kernel(case, dtype, masked):
    B, S, H, G, P, N, chunk = CASES[case]
    args = ssd_inputs(B, S, H, G, P, N, dtype)
    hm = _masks(H)[masked]
    want_y, want_s = ref_ssd_scan(*(jnp.asarray(a) for a in args),
                                  head_mask=None if hm is None
                                  else jnp.asarray(hm),
                                  chunk=chunk, interpret=True)
    got_y, got_s = ssd_scan(*(to_port(a) for a in args),
                            head_mask=None if hm is None
                            else torch.from_numpy(hm), chunk=chunk)
    assert got_y.shape == (B, S, H, P) and got_y.dtype == to_port(args[0]).dtype
    assert got_s.shape == (B, H, P, N) and got_s.dtype == torch.float32
    tol_y, tol_s = ssd_tolerance(*args, chunk)
    if hm is not None:
        tol_y = tol_y * hm[None, None, :, None]
    if dtype == "bfloat16":
        tol_y = tol_y + BF16_SPACING * (np.abs(to_f32(want_y)) + tol_y)
    assert _ok(got_y, want_y, tol_y)
    assert _ok(got_s, want_s, tol_s)
    assert np.isfinite(to_f32(got_y)).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference_plain_version(case):
    """fp32 ``ssd_chunked`` against the reference's, at the reference's
    chunk: the same algorithm, y unrounded."""
    B, S, H, G, P, N, chunk = CASES[case]
    args = ssd_inputs(B, S, H, G, P, N, seed=2)
    want_y, want_s = ssd_ref(*(jnp.asarray(a) for a in args), chunk)
    got_y, got_s = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    tol_y, tol_s = ssd_tolerance(*args, chunk)
    assert _ok(got_y, want_y, tol_y) and _ok(got_s, want_s, tol_s)


def _sequential(xh, dt, A, Bm, Cm):
    """O(S) step-by-step recurrence in float64, the scan's definition:
    state <- state e^(dt A) + dt x B^T, y = state C."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = np.repeat(Bm.astype(np.float64), H // G, 2)
    Ch = np.repeat(Cm.astype(np.float64), H // G, 2)
    x, d = xh.astype(np.float64), dt.astype(np.float64)
    y = np.zeros((B, S, H, P))
    st = np.zeros((B, H, P, N))
    for t in range(S):
        st = (st * np.exp(d[:, t] * A)[..., None, None]
              + np.einsum("bh,bhp,bhn->bhpn", d[:, t], x[:, t], Bh[:, t]))
        y[:, t] = np.einsum("bhpn,bhn->bhp", st, Ch[:, t])
    return y, st


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("case", ["ragged_77", "groups_2", "s1"])
def test_chunk_lengths_agree_with_the_sequential_recurrence(case, chunk):
    """The result does not depend on the chunk length (the kernel walks
    64-step chunks, the plain version the model's): every chunk length
    gives the float64 step-by-step recurrence within the tolerance."""
    B, S, H, G, P, N, _ = CASES[case]
    args = ssd_inputs(B, S, H, G, P, N, seed=3)
    want_y, want_s = _sequential(*args)
    got_y, got_s = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    tol_y, tol_s = ssd_tolerance(*args, max(chunk, 64))
    assert _ok(got_y, want_y, tol_y) and _ok(got_s, want_s, tol_s)


def test_head_mask_zeroes_pruned_heads_and_keeps_every_state():
    """Pruned heads' y are exact zeros, kept heads' y and every head's
    final state (pruned ones included, unmasked) equal the unmasked run's,
    as the reference's kernel writes them (kernel.py:77,84)."""
    args = [torch.from_numpy(a) for a in ssd_inputs(2, 77, 8, 2, 16, 32,
                                                    "float32", seed=4)]
    hm = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.float32)
    y, st = ssd_scan(*args, head_mask=hm, chunk=32)
    y1, st1 = ssd_scan(*args, chunk=32)
    assert (y[:, :, hm == 0] == 0).all()
    assert torch.equal(y[:, :, hm == 1], y1[:, :, hm == 1])
    assert torch.equal(st, st1)
    assert (st[:, hm == 0].abs().amax() > 0)


def test_fast_decay_never_overflows_into_nan():
    """A = -16 with dt up to ~3 drives the within-chunk cumulative decay
    to -3000 and beyond: exp(cs_i - cs_j) above the diagonal would
    overflow, and must be selected away, not multiplied by 0."""
    xh, dt, A, Bm, Cm = ssd_inputs(1, 256, 4, 1, 16, 16, seed=5)
    dt = dt * 30.0
    A = np.full_like(A, -16.0)
    y, st = ssd_scan_ref(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)),
                         chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want_y, want_s = _sequential(xh, dt, A, Bm, Cm)
    tol_y, tol_s = ssd_tolerance(xh, dt, A, Bm, Cm, 256)
    assert _ok(y, want_y, tol_y) and _ok(st, want_s, tol_s)


def test_cpu_wrapper_takes_strided_slices_without_a_launch():
    """The Mamba2 block hands in x, B and C as slices of its conv output;
    on the CPU the wrapper runs the plain version on them, no launch."""
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssd_inputs(
        2, 40, 4, 1, 16, 16, seed=6))
    xBC = torch.cat([xh.reshape(2, 40, -1), Bm.reshape(2, 40, -1),
                     Cm.reshape(2, 40, -1)], -1)
    views = (xBC[..., :64].reshape(2, 40, 4, 16),
             xBC[..., 64:80].reshape(2, 40, 1, 16),
             xBC[..., 80:].reshape(2, 40, 1, 16))
    before = ssd_scan.launches
    y, st = ssd_scan(views[0], dt, A, views[1], views[2], chunk=16)
    y1, st1 = ssd_scan(xh, dt, A, Bm, Cm, chunk=16)
    assert torch.equal(y, y1) and torch.equal(st, st1)
    assert ssd_scan.launches == before


def test_cuda_operand_checks():
    """What the wrapper refuses before a launch (checked on CPU tensors:
    the checks read shapes, dtypes and strides only)."""
    args = [torch.from_numpy(a) for a in ssd_inputs(1, 8, 4, 2, 64, 64,
                                                    seed=7)]
    hm = torch.ones(4)
    ops._check_cuda_operands(*args, hm)
    bad_pn = [torch.from_numpy(a) for a in ssd_inputs(1, 8, 4, 2, 32, 64)]
    with pytest.raises(ValueError, match="P, N"):
        ops._check_cuda_operands(*bad_pn, hm)
    with pytest.raises(TypeError, match="dt"):
        ops._check_cuda_operands(args[0], args[1].double(), *args[2:], hm)
    with pytest.raises(TypeError, match="Bm"):
        ops._check_cuda_operands(args[0], args[1], args[2],
                                 args[3].bfloat16(), args[4], hm)
    with pytest.raises(ValueError, match="line up"):
        ops._check_cuda_operands(*args[:3], args[3][:, :, :1].expand(
            1, 8, 3, 64), args[4][:, :, :1].expand(1, 8, 3, 64), hm)
    with pytest.raises(ValueError, match="device"):
        ssd_scan(*(a.to("meta") for a in args))
    assert ops._strides_ok(args[0])
    assert not ops._strides_ok(args[0].transpose(2, 3))
