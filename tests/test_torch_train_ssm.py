"""Training the SSM and hybrid families on the CPU against the reference
at the smoke size: mamba2-2.7b (Mamba2 blocks: the SSD scan and the gated
norm, each through its plain version, as the reference trains with its
Pallas dispatch off) and zamba2-1.2b (the same blocks with the shared
attention + GELU-MLP block after each layer), loss and every gradient in
float32 (``torch_parity.LOSS_RTOL32`` / ``GRAD_RTOL32``). On the card
these configs are refused until the SSD scan and the gated norm have
gradients (ROADMAP A7e)."""
from __future__ import annotations

import pytest

from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference)
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from torch_parity import (LOSS_RTOL32, assert_grads_close32, port_batch,
                          port_grad_leaves, port_loss_and_grads,
                          reference_loss_and_grads, train_batch_np,
                          train_setup)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_loss_and_grads_match_reference_fp32(arch, masked):
    cr, ct, pn, mn = train_setup(arch, masked=masked)
    bn = train_batch_np(cr, 2, 12)
    loss_r, met_r, grads_r = reference_loss_and_grads(cr, pn, bn, mn)
    loss, met, grads = port_loss_and_grads(
        ct, transformer_params_from_reference(pn), port_batch(bn),
        transformer_masks_from_reference(mn))
    assert abs(float(loss) - loss_r) <= LOSS_RTOL32 * abs(loss_r)
    assert met["moe_aux"] == met_r["moe_aux"] == 0.0
    assert_grads_close32(port_grad_leaves(grads), grads_r)


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_train_step_refuses_ssm_and_hybrid_on_the_card(arch, device):
    """The refusal names A7e and comes before the device is looked for:
    nothing falls back to the plain path or the CPU."""
    _, ct, _, _ = train_setup(arch, masked=False)
    with pytest.raises(NotImplementedError, match="A7e"):
        make_train_step(ct, adamw(constant(1e-3)), device=device)
