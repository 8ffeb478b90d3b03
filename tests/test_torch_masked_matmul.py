"""The port's column-masked GEMM wrapper (``repro_torch.kernels
.masked_matmul``) against the reference's Pallas kernel run in interpret
mode on the same numpy operands. On the CPU the wrapper runs the plain
PyTorch version; the CUDA kernel is held against that plain version on
the card by ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.masked_matmul.ops import masked_matmul as ref_masked_matmul
from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from torch_parity import EPS32
from torch_parity import one_thread  # noqa: F401 (autouse)

# (M, K, N, mask kind)
CASES = {
    "square": (64, 64, 64, "ones"),
    "ragged": (77, 29, 45, "partial"),
    "m1": (1, 300, 50, "partial"),
    "n38": (10, 40, 38, "ones"),
    "k_not_16": (33, 23, 17, "partial"),
    "partial_mask": (48, 96, 80, "partial"),
    "zero_mask": (20, 36, 24, "zeros"),
    "m0": (0, 16, 8, "ones"),
    "n0": (8, 16, 0, "ones"),
    "k0": (8, 0, 16, "partial"),
}


def _operands(M, K, N, kind, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    if kind == "ones":
        m = np.ones(N, np.float32)
    elif kind == "zeros":
        m = np.zeros(N, np.float32)
    else:
        m = (rng.random(N) < 0.5).astype(np.float32)
    return a, b, m


def _tol(a, b):
    """Elementwise bound on the gap between two fp32 sums of the same
    K products taken in different orders: each errs by at most K·u·
    sum|a_k b_k| (u = eps/2), so the two differ by at most K·eps·(|A|@|B|)
    — the worst case, which no correct kernel exceeds."""
    K = a.shape[1]
    return K * EPS32 * (np.abs(a) @ np.abs(b)) + 1e-30


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference_pallas_kernel(case):
    M, K, N, kind = CASES[case]
    a, b, m = _operands(M, K, N, kind)
    want = np.asarray(ref_masked_matmul(a, b, m, interpret=True))
    got = masked_matmul(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(m))
    assert got.shape == want.shape == (M, N)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert (np.abs(got - want) <= _tol(a, b)).all()
    # a pruned column is an exact zero, as in the reference
    assert (got[:, m == 0] == 0).all()
    assert (want[:, m == 0] == 0).all()


def test_wrapper_flattens_leading_dims_without_a_launch():
    """(..., K) operands come back as (..., N), equal to the plain version
    on the flattened rows; a CPU call counts no kernel launch."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 3, 5, 19), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((19, 11), dtype=np.float32))
    m = torch.from_numpy((rng.random(11) < 0.5).astype(np.float32))
    before = masked_matmul.launches
    out = masked_matmul(a, b, m)
    assert out.shape == (2, 3, 5, 11)
    torch.testing.assert_close(out.reshape(30, 11),
                               masked_matmul_ref(a.reshape(30, 19), b, m),
                               rtol=0, atol=0)
    assert masked_matmul.launches == before
    # the degenerate dims keep the leading shape too
    empty = masked_matmul(a[:, :0], b, m)
    assert empty.shape == (2, 0, 5, 11)


# bf16 operands, as the pruned transformer's FFN up and gate products give
# them (M = B*S, K = d_model, N = d_ff, at the tests' small widths)
BF16_CASES = {
    "ffn_smoke": (40, 256, 512, "partial"),
    "ragged": (77, 29, 45, "partial"),
    "m1": (1, 256, 512, "partial"),
    "all_kept": (16, 64, 96, "ones"),
    "zero_mask": (8, 32, 24, "zeros"),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_matches_reference_pallas_kernel(case):
    """Both accumulate the bf16 products in fp32 and round the masked sum
    to bf16 once: the fp32 sums differ by at most K·eps·(|A|@|B|) and the
    roundings by one bf16 spacing more."""
    import jax.numpy as jnp
    from repro_torch.interop import transformer_params_from_reference
    from torch_parity import BF16_SPACING, to_f32
    M, K, N, kind = BF16_CASES[case]
    a, b, m = _operands(M, K, N, kind, seed=7)
    a16, b16 = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    want = to_f32(ref_masked_matmul(jnp.asarray(a16), jnp.asarray(b16),
                                    jnp.asarray(m), interpret=True))
    ta, tb = transformer_params_from_reference([a16, b16])
    got = masked_matmul(ta, tb, torch.from_numpy(m))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    got = to_f32(got)
    fp32 = _tol(to_f32(a16), to_f32(b16))
    tol = fp32 + BF16_SPACING * (np.abs(want) + fp32)
    assert (np.abs(got - want) <= tol).all()
    assert (got[:, m == 0] == 0).all()
