"""The port's RMSNorm wrapper (``repro_torch.kernels.rmsnorm``) and norm
layers against the reference's Pallas kernel run in interpret mode and its
layers, on the same numpy inputs. On the CPU the wrapper runs the plain
PyTorch version; the CUDA kernel is held against that plain version on
the card by ``chip_smoke.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as ref_rmsnorm_kernel
from repro.models.layers import norms as rnorms
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.layers import norms as tnorms
from torch_parity import BF16_SPACING, EPS32, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

SHAPES = [(8, 64), (3, 5, 128), (1, 1, 1, 256), (300, 96), (77, 3584)]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x.astype(DTYPES[dtype]), s.astype(DTYPES[dtype])


def _tol(want: np.ndarray, d: int, dtype: str) -> np.ndarray:
    """Elementwise bound between two fp32 evaluations of the same RMSNorm,
    then rounded to ``dtype``: the two sums of d squares taken in other
    orders differ by at most d·eps relative, rsqrt against 1/sqrt and the
    two products by a few eps more, so the fp32 values differ by at most
    (d/2 + 4)·eps·|y| after the square root; bf16 adds one spacing."""
    fp32 = (d / 2 + 4) * EPS32 * np.abs(want)
    if dtype == "float32":
        return fp32 + 1e-30
    return fp32 + BF16_SPACING * (np.abs(want) + fp32) + 1e-30


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_reference_pallas_kernel(shape, offset, dtype):
    x, s = _inputs(shape, dtype)
    want = to_f32(ref_rmsnorm_kernel(jnp.asarray(x), jnp.asarray(s),
                                     eps=1e-6, scale_offset=offset,
                                     interpret=True))
    tx, ts = to_port(x), to_port(s)
    got = rmsnorm(tx, ts, eps=1e-6, scale_offset=offset)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert (np.abs(to_f32(got) - want) <= _tol(want, shape[-1], dtype)).all()


def test_wrapper_counts_no_launch_on_the_cpu():
    x, s = _inputs((4, 6, 32), "float32", seed=3)
    before = rmsnorm.launches
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5, 1.0)
    torch.testing.assert_close(got, rmsnorm_ref(torch.from_numpy(x),
                                                torch.from_numpy(s), 1e-5,
                                                1.0), rtol=0, atol=0)
    assert rmsnorm.launches == before


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_norm_layer_matches_reference_layer(backend):
    x, s = _inputs((2, 9, 64), "float32", seed=4)
    want = np.asarray(rnorms.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6,
                                     0.5))
    got = tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6,
                         0.5, backend=backend).numpy()
    assert (np.abs(got - want) <= _tol(want, 64, "float32")).all()


def test_layernorm_and_gated_rmsnorm_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32) * 2 + 0.5
    z = rng.standard_normal((3, 7, 48)).astype(np.float32) * 4
    s = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    t = torch.from_numpy
    for want, got in (
            (rnorms.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)),
             tnorms.layernorm(t(x), t(s), t(b))),
            (rnorms.gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(s)),
             tnorms.gated_rmsnorm(t(x), t(z), t(s)))):
        want = np.asarray(want)
        # the same fp32 formula in another order: 64 eps of the largest
        # entry, as for the CNN layers (torch_parity.fp32_tol)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=64 * EPS32 * np.abs(want).max())
