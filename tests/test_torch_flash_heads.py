"""``flash_attention`` at the head dims beside 64 and 128 (HuBERT's 80,
and the large 192 and 256): the bf16 entry's numerics held against the
reference's Pallas kernel, the CUDA kernel's head-dim instances, and every
registry config either building its prefill step for the card or being
refused when the step is built, never deep in a layer."""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro_torch.configs import registry
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.build import CSRC_DIR
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.transformer import check_supported
from torch_parity import flash_bf16_tolerance, p_in_bf16_attention, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

# (B, S, H, Hkv, D, causal, window): gemma-7b's 16/16 heads of 256,
# nemotron-4-340b's 96/8 heads of 192 and hubert-xlarge's non-causal 16/16
# heads of 80, cut in width to the CPU's size
HEAD_CASES = {
    "d80_noncausal": (1, 40, 16, 16, 80, False, None),
    "d80_ragged": (2, 33, 4, 4, 80, False, None),
    "d80_gqa": (1, 77, 8, 2, 80, True, None),
    "d256_mha": (1, 40, 2, 2, 256, True, None),
    "d256_ragged": (2, 33, 4, 2, 256, True, None),
    "d256_window": (1, 48, 2, 1, 256, True, 9),
    "d192_gqa": (1, 40, 12, 1, 192, True, None),
    "d192_ragged": (1, 77, 4, 2, 192, True, None),
    "d192_noncausal": (2, 24, 4, 4, 192, False, None),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_bf16_numerics_hold_the_reference_at_large_head_dims(case):
    """The bf16 entry's arithmetic (P rounded to bf16 before P·V) against
    the reference's Pallas kernel in interpret mode, within the stated
    bf16 tolerance (``flash_bf16_tolerance``)."""
    B, S, H, Hkv, D, causal, window = HEAD_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(shp).astype(np.float32).astype(
        jnp.bfloat16) for shp in ((B, S, H, D), (B, S, Hkv, D),
                                  (B, S, Hkv, D)))
    want = to_f32(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, interpret=True))
    got = to_f32(p_in_bf16_attention(to_port(q), to_port(k), to_port(v),
                                     causal, window))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= flash_bf16_tolerance(to_f32(v),
                                                       want)).all()


def test_every_head_dim_has_an_instance_in_both_entries():
    """Each launcher of ``csrc/flash_attention.cu`` (fp32 ``launch``, bf16
    ``launch_mma``) dispatches exactly the wrapper's ``HEAD_DIMS``, 80
    among them."""
    assert 80 in ops.HEAD_DIMS
    src = (CSRC_DIR / "flash_attention.cu").read_text()
    for launcher in ("int launch(", "int launch_mma("):
        body = src[src.index(launcher):]
        body = body[:body.index("cudaErrorInvalidValue")]
        dims = tuple(int(d) for d in re.findall(r"if \(D == (\d+)\)", body))
        assert dims == ops.HEAD_DIMS, launcher


@pytest.mark.parametrize("D", [64, 80, 128, 192, 256, 96])
def test_operand_check_takes_exactly_the_kernel_head_dims(D):
    q = torch.zeros(1, 4, 2, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 1, D, dtype=torch.bfloat16)
    if D in ops.HEAD_DIMS:
        ops._check_cuda_operands(q, k, k)
    else:
        with pytest.raises(ValueError, match="head dims"):
            ops._check_cuda_operands(q, k, k)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_registry_config_builds_its_card_step_or_is_refused_there(
        arch, monkeypatch):
    """On the card path (``torch.cuda.is_available`` patched true: building
    a step touches no device) every registry config builds its prefill
    step: the stack serves every family, and every GQA head dim of the
    registry (HuBERT's 80 among them) is one the kernel has. None is
    refused any more."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = registry.get_config(arch)
    check_supported(cfg)
    assert callable(make_prefill_step(cfg))
    if cfg.num_heads:
        assert cfg.head_dim in ops.HEAD_DIMS


def test_card_step_refuses_a_head_dim_the_kernel_lacks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = registry.get_smoke_config("qwen2-7b").replace(head_dim=96)
    with pytest.raises(ValueError, match="head dims"):
        make_prefill_step(cfg)
    # the CPU path takes any head dim through the plain version
    assert callable(make_prefill_step(cfg, device="cpu"))
