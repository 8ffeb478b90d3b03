"""Training the MoE families against the reference at the smoke size:
mixtral-8x7b (sort-dispatch MoE, sliding window, the router losses summed
over the MoE run) and deepseek-v3-671b (MLA, a dense ``attn_dense`` layer
before the MoE layer, sigmoid scores with a shared expert, and the MTP
loss over the ``mtp`` subtree: [hidden; next embedding] projected, the
GQA block of the MTP config, its norm, labels two ahead). The port's
``loss_fn`` and every gradient against ``jax.value_and_grad`` of the
reference's ``loss_fn`` in float32 (``torch_parity.LOSS_RTOL32`` /
``GRAD_RTOL32``); bf16 is not held here, because one bf16 rounding can
move a token across the top-k boundary in either package (ROADMAP §C
item 2)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference)
from repro_torch.models import transformer as ttr
from torch_parity import (LOSS_RTOL32, assert_grads_close32, port_batch,
                          port_grad_leaves, port_loss_and_grads,
                          reference_loss_and_grads, train_batch_np,
                          train_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_loss_and_grads_match_reference_fp32(arch, masked):
    cr, ct, pn, mn = train_setup(arch, masked=masked)
    bn = train_batch_np(cr, 2, 12)
    loss_r, met_r, grads_r = reference_loss_and_grads(cr, pn, bn, mn)
    loss, met, grads = port_loss_and_grads(
        ct, transformer_params_from_reference(pn), port_batch(bn),
        transformer_masks_from_reference(mn))
    assert set(met) == set(met_r)
    assert ("mtp" in met) == bool(ct.mtp_depth)
    assert met["moe_aux"] > 0 and met["moe_z"] > 0
    assert abs(float(loss) - loss_r) <= LOSS_RTOL32 * abs(loss_r)
    for k in met_r:
        assert abs(met[k] - met_r[k]) <= LOSS_RTOL32 * max(abs(met_r[k]), 1)
    assert_grads_close32(port_grad_leaves(grads), grads_r)


def test_mtp_loss_is_the_reference_weighting_and_label_shift():
    """The MTP term enters at weight 0.1, over labels two ahead (S - 1
    positions, the last -1): setting every label but the first two to -1
    leaves the MTP loss over nothing (zero), and the total is then the
    main loss plus the router losses alone."""
    cr, ct, pn, mn = train_setup("deepseek-v3-671b", masked=False)
    bn = train_batch_np(cr, 2, 12)
    params = transformer_params_from_reference(pn)
    batch = port_batch(bn)
    with torch.no_grad():
        total, met = ttr.loss_fn(params, ct, batch)
        assert float(total) == pytest.approx(
            met["xent"] + met["moe_aux"] + met["moe_z"]
            + ttr.MTP_WEIGHT * met["mtp"], rel=1e-6)
        batch["labels"][:, 2:] = -1
        total, met = ttr.loss_fn(params, ct, batch)
    assert float(met["mtp"]) == 0.0
    assert float(total) == pytest.approx(
        float(met["xent"] + met["moe_aux"] + met["moe_z"]), rel=1e-6)
    loss_r, met_r, _ = reference_loss_and_grads(
        cr, pn, dict(bn, labels=batch["labels"].numpy().astype(np.int32)))
    assert met_r["mtp"] == 0.0
    assert abs(float(total) - loss_r) <= LOSS_RTOL32 * abs(loss_r)
