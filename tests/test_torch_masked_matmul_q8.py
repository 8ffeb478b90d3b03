"""``masked_matmul_q8``: the column-masked GEMM with B as uint8 codes, which
the CUDA kernels dequantize as they load them (``csrc/masked_matmul.cu``,
one rounding for the product and one for the sum, as
``quant.dequantize_weights`` rounds them). On the CPU the wrapper
dequantizes, then runs the plain version: that path must be, bit for bit,
dequant-then-``masked_matmul_ref``, and the quantized edge forward must take
it. Parity of the edge forward with the JAX reference is held in
``test_torch_quant.py``; the kernels are held to the same bits on the card
by ``chip_smoke.py`` (the split-K route against the float32 route on the
dequantized weights)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.collab import quant as tquant
from repro_torch.kernels.masked_matmul import ops
from repro_torch.kernels.masked_matmul.ops import masked_matmul_q8
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
from torch_parity import port_masks, port_params, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)

# name: (M, K, N, bits, per_channel); AlexNet-like shapes at small widths
CASES = {
    "conv_int8_per_channel": (121, 75, 24, 8, True),
    "dense_int8_per_channel": (1, 288, 40, 8, True),
    "dense_n38_int8": (2, 128, 38, 8, True),
    "int8_per_tensor": (33, 64, 48, 8, False),
    "int4_per_channel": (16, 96, 20, 4, True),
}


def _bank(M, K, N, bits, per_channel, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    codes, scale, zero = tquant.quantize_weights(w, bits, per_channel)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    m = torch.from_numpy((rng.random(N) < 0.5).astype(np.float32))
    lp = {"wq": torch.from_numpy(codes), "scale": torch.as_tensor(scale),
          "zero": torch.as_tensor(zero)}
    return a, lp, m


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_is_dequant_then_plain_gemm(case):
    """Bit for bit, per-channel and per-tensor (scale and zero broadcast)
    pairs alike; pruned columns exact zeros; no launch on the CPU."""
    a, lp, m = _bank(*CASES[case])
    before = ops.masked_matmul.launches
    got = masked_matmul_q8(a, lp["wq"], lp["scale"], lp["zero"], m)
    want = masked_matmul_ref(a, tquant.dequantize_weights(lp), m)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (got[:, m == 0] == 0).all()
    assert ops.masked_matmul.launches == before


def test_leading_dims_and_empty_operands():
    """(..., K) rows come back as (..., N); an empty M or K gives zeros of
    the right shape, as ``masked_matmul`` does."""
    a, lp, m = _bank(12, 64, 16, 8, True, seed=1)
    args = (lp["wq"], lp["scale"], lp["zero"], m)
    out = masked_matmul_q8(a.reshape(3, 4, 64), *args)
    assert out.shape == (3, 4, 16)
    assert torch.equal(out.reshape(12, 16), masked_matmul_q8(a, *args))
    assert masked_matmul_q8(a[:0], *args).shape == (0, 16)
    empty_k = masked_matmul_q8(a[:, :0], lp["wq"][:0], *args[1:])
    assert empty_k.shape == (12, 16) and (empty_k == 0).all()


@pytest.mark.parametrize("bits", [8, 4, None])
def test_edge_forward_takes_the_codes_path(bits):
    """``quant_cnn_apply`` with the kernel backend gives, on the CPU, the
    plain backend's bits: a quantized layer goes through
    ``masked_matmul_q8`` (dequant, then the plain GEMM), an fp32 layer
    through ``masked_matmul``."""
    _, cfg, params, masks, x = tiny_setup()
    pol = tquant.QuantPolicy(weight_bits=bits)
    q = tquant.quantize_params(port_params(params), cfg, pol)
    m = port_masks(masks)
    xt = torch.from_numpy(x)
    kernel = tquant.quant_cnn_apply(q, cfg, xt, masks=m, backend="pallas")
    plain = tquant.quant_cnn_apply(q, cfg, xt, masks=m, backend="ref")
    assert torch.equal(kernel, plain)


def test_cuda_operand_checks():
    """What the codes wrapper refuses before a launch (checked on CPU
    tensors: the checks read shapes, dtypes and layout only)."""
    a, lp, m = _bank(8, 32, 16, 8, True, seed=2)
    codes, scale, zero = lp["wq"], lp["scale"], lp["zero"]
    more = (("scale", scale), ("zero", zero))
    ops._check_cuda_operands(a, codes, m, torch.uint8, *more)
    with pytest.raises(TypeError, match="b as torch.uint8"):
        ops._check_cuda_operands(a, codes.float(), m, torch.uint8, *more)
    with pytest.raises(ValueError, match="line up"):
        ops._check_cuda_operands(a, codes, m, torch.uint8,
                                 ("scale", scale[:8]), ("zero", zero))
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda_operands(a, codes.t().contiguous().t(), m,
                                 torch.uint8, *more)
    with pytest.raises(ValueError, match="device"):
        masked_matmul_q8(a.to("meta"), codes, scale, zero, m)
