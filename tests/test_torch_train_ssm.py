"""Training the SSM and hybrid families on the CPU against the reference
at the smoke size: mamba2-2.7b (Mamba2 blocks: the SSD scan and the gated
norm, each an autograd Function whose CPU forward is its plain version
and whose backward is the one the card runs; the reference trains with
its Pallas dispatch off) and zamba2-1.2b (the same blocks with the shared
attention + GELU-MLP block after each layer, after every layer at the
smoke period of 1), loss and every gradient in float32
(``torch_parity.LOSS_RTOL32`` / ``GRAD_RTOL32``): at 12 tokens, and with
remat on at 40 (past the smoke chunk of 32, so the backward's reverse
state pass carries a state across chunks); one AdamW step through
``make_train_step(device="cpu")`` against the reference's; the pruned
SSD heads' gradient slices exactly zero (``chip_smoke.pruned_grads``);
one step's calls of each kernel wrapper's serving path (what launches on
the card) equal to ``chip_smoke.expected_train_launches``. With no card
here, ``make_train_step`` on the card raises ``resolve_device``'s
error: nothing refuses the families any more."""
from __future__ import annotations

import importlib.util
import os

import pytest
import torch

from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference)
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from torch_parity import (LOSS_RTOL32, adamw_step_both,
                          assert_adamw_step_close, assert_grads_close32,
                          port_batch, port_grad_leaves, port_loss_and_grads,
                          reference_loss_and_grads, train_batch_np,
                          train_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

#: ``chip_smoke.py``'s ``pruned_grads`` and ``expected_train_launches``,
#: which phase 20 holds on the card
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def _loss_and_grads_match(arch, masked, S, **overrides):
    cr, ct, pn, mn = train_setup(arch, masked=masked, **overrides)
    bn = train_batch_np(cr, 2, S)
    loss_r, met_r, grads_r = reference_loss_and_grads(cr, pn, bn, mn)
    loss, met, grads = port_loss_and_grads(
        ct, transformer_params_from_reference(pn), port_batch(bn),
        transformer_masks_from_reference(mn))
    assert abs(float(loss) - loss_r) <= LOSS_RTOL32 * abs(loss_r)
    assert met["moe_aux"] == met_r["moe_aux"] == 0.0
    assert_grads_close32(port_grad_leaves(grads), grads_r)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_loss_and_grads_match_reference_fp32(arch, masked):
    _loss_and_grads_match(arch, masked, 12)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_loss_and_grads_match_reference_past_the_chunk_with_remat(arch,
                                                                  masked):
    cr, *_ = train_setup(arch, masked=False)
    assert cr.ssm.chunk_size < 40
    if arch == "zamba2-1.2b":
        assert cr.shared_attn_period == 1
    _loss_and_grads_match(arch, masked, 40, remat=True)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_adamw_step_matches_reference(arch):
    cr, *_ = train_setup(arch, masked=False)
    _, pn, ref, port = adamw_step_both(arch, train_batch_np(cr, 2, 12))
    assert_adamw_step_close(pn, ref, port)


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_train_step_refuses_ssm_and_hybrid_on_the_card(arch, device):
    """No family is refused on the card any more: with no card present
    (as here) the only error is ``resolve_device``'s, raised when the step
    is made. Nothing falls back to the plain path or the CPU."""
    _, ct, _, _ = train_setup(arch, masked=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(ct, adamw(constant(1e-3)), device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_pruned_ssd_heads_get_exact_zero_gradients(arch, dtype):
    """Each pruned SSD head's ``w_in`` columns of z, x and dt, its conv
    columns, ``dt_bias``, ``A_log``, ``D``, ``norm_scale`` entries and
    ``w_out`` rows get exactly zero through the Functions' backwards; a
    kept head's do not."""
    _, ct, pn, mn = train_setup(arch, dtype=dtype)
    masks = transformer_masks_from_reference(mn)
    _, _, grads = port_loss_and_grads(
        ct, transformer_params_from_reference(pn),
        port_batch(train_batch_np(ct, 2, 40)), masks)
    pruned = smoke.pruned_grads(ct, grads, masks)
    heads = masks[0]["ssm_head_mask"]
    assert len(pruned) == 10 * ct.num_layers and (heads == 0).any()
    assert not any(t.any() for t in pruned)
    kept = smoke.ssd_head_grads(ct, {k: t[0] for k, t in
                                     grads["runs"][0]["ssm"].items()},
                                heads[0] > 0)
    assert all(t.abs().sum() > 0 for t in kept)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_train_step_calls_each_kernel_as_phase_20_expects(arch,
                                                          monkeypatch):
    """One remat step on the CPU: the calls of each wrapper's serving path
    (on the card, one launch each) equal ``expected_train_launches``."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.masked_matmul import ops as mops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssd_scan import ops as sops
    calls = dict.fromkeys(("rmsnorm", "rmsnorm_gated", "masked_matmul",
                           "flash_attention", "ssd_scan"), 0)
    for mod, name, key in ((rops, "_rmsnorm", "rmsnorm"),
                           (rops, "_gated_rmsnorm", "rmsnorm_gated"),
                           (mops, "_masked_matmul", "masked_matmul"),
                           (fops, "_flash_attention", "flash_attention"),
                           (sops, "_ssd_scan", "ssd_scan")):
        def counted(*a, _real=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    _, ct, pn, mn = train_setup(arch, remat=True)
    tp = transformer_params_from_reference(pn)
    opt = adamw(constant(1e-3))
    step = make_train_step(ct, opt, transformer_masks_from_reference(mn),
                           device="cpu")
    _, _, metrics = step(tp, opt.init(tp), train_batch_np(ct, 1, 40))
    assert torch.isfinite(metrics["loss"])
    want = smoke.expected_train_launches(ct)
    assert calls == {k: want[k] for k in calls}
    assert calls["ssd_scan"] == calls["rmsnorm_gated"] == 2 * ct.num_layers
