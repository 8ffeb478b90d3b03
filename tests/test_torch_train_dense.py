"""Training the dense, vision-language and audio families
(``repro_torch.models.transformer.loss_fn`` and its gradients through the
port's kernel wrappers, which on the CPU run their plain versions under
the same autograd Functions the card runs) against ``jax.value_and_grad``
of the reference's ``loss_fn`` on the same numpy parameters, batch and
masks, at the smoke size: qwen2-7b (QKV bias), gemma-7b (scale offset,
logit softcap, scaled embeddings, tied head), qwen2-vl-7b (the -1 label
pad over its 16 vision tokens, M-RoPE) and hubert-xlarge (frame
embeddings, bidirectional, an unused token embedding whose gradient is
zero in both).

Tolerances: float32 as ``torch_parity.LOSS_RTOL32`` / ``GRAD_RTOL32``
(loss 1e-5 relative; each leaf within 1e-4 of its largest reference
entry). bf16: each leaf no farther from the reference's float32 gradient
than twice the reference's own bf16 gradient is, plus one bf16 spacing of
the float32 leaf's largest entry (bf16 rounds at other points in XLA and
PyTorch; the reference's own bf16 run is the measure of that).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference)
from torch_parity import (BF16_SPACING, LOSS_RTOL32, assert_grads_close32,
                          port_batch, port_grad_leaves, port_loss_and_grads,
                          reference_loss_and_grads, to_f32, train_batch_np,
                          train_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

FAMILIES = ["qwen2-7b", "gemma-7b", "qwen2-vl-7b", "hubert-xlarge"]


def _port(ct, pn, bn, mn):
    return port_loss_and_grads(ct, transformer_params_from_reference(pn),
                               port_batch(bn),
                               transformer_masks_from_reference(mn))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference_fp32(arch, masked):
    cr, ct, pn, mn = train_setup(arch, masked=masked)
    bn = train_batch_np(cr, 2, 12)
    loss_r, met_r, grads_r = reference_loss_and_grads(cr, pn, bn, mn)
    loss, met, grads = _port(ct, pn, bn, mn)
    assert set(met) == set(met_r) == {"xent", "moe_aux", "moe_z", "loss"}
    assert abs(float(loss) - loss_r) <= LOSS_RTOL32 * abs(loss_r)
    for k in met_r:
        assert abs(met[k] - met_r[k]) <= LOSS_RTOL32 * max(abs(met_r[k]), 1)
    assert_grads_close32(port_grad_leaves(grads), grads_r)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference_bf16(arch):
    cr, ct, pn, mn = train_setup(arch, dtype="bfloat16")
    cr32 = cr.replace(dtype="float32")
    bn = train_batch_np(cr, 2, 12)
    pn32 = jax.tree_util.tree_map(to_f32, pn)
    bn32 = {k: to_f32(v) if k in ("embeds", "vision_embeds") else v
            for k, v in bn.items()}
    loss32, _, g32 = reference_loss_and_grads(cr32, pn32, bn32, mn)
    loss16, _, g16 = reference_loss_and_grads(cr, pn, bn, mn)
    loss, _, grads = _port(ct, pn, bn, mn)
    spread = abs(loss16 - loss32)
    assert abs(float(loss) - loss32) <= (2 * spread + BF16_SPACING
                                         * abs(loss32))
    got = port_grad_leaves(grads)
    assert len(got) == len(g32)
    for g, w16, w32 in zip(got, g16, g32):
        w32 = to_f32(w32)
        tol = (2 * np.abs(to_f32(w16) - w32).max()
               + BF16_SPACING * np.abs(w32).max())
        assert np.abs(to_f32(g) - w32).max() <= tol
