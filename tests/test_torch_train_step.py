"""The port's training step (``repro_torch.launch.steps.make_train_step``)
and what it rests on, at the smoke size on the CPU:

* one AdamW step against the reference's ``make_train_step`` on the same
  numpy parameters, batch and masks: the metrics within
  ``torch_parity.LOSS_RTOL32``; the first moment within
  ``GRAD_RTOL32`` of its largest entry and the second within twice that
  (it is the square); each parameter within 64 eps of its largest entry,
  except where the reference's gradient lies within the gradient
  tolerance of zero, where AdamW's first step (lr x g / (|g| + eps), about
  lr x sign g) may go either way: there within 2 lr;
* ``grad_accum`` 2 against 1 and against the reference's ``grad_accum`` 2
  on qwen2-vl, whose ``mrope_positions`` (3, B, S) split on dim 1;
* remat on against off, bit for bit, with each checkpointed block run
  twice (the forward, and the backward's recompute);
* the pruned units' gradients exactly zero;
* ``MarkovTokens`` bit-equal to the reference's; ``batch_on`` moving the
  labels as int64; a few CPU steps lowering the loss.
"""
from __future__ import annotations

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import MarkovTokens as RMarkov
from repro_torch.data.requests import request_batch
from repro_torch.data.tokens import MarkovTokens as TMarkov
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.launch.steps import batch_on, make_train_step
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from torch_parity import (LOSS_RTOL32, adamw_step_both,
                          assert_adamw_step_close, port_batch,
                          port_loss_and_grads, train_batch_np, train_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

#: ``chip_smoke.py``'s ``pruned_grads``: one list of the pruned units'
#: gradient slices for the card and for these tests
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

LR = 1e-3


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v3-671b"])
def test_adamw_step_matches_reference(arch):
    cr, *_ = train_setup(arch, masked=False)
    cr, pn, ref, port = adamw_step_both(arch, train_batch_np(cr, 2, 12))
    assert_adamw_step_close(pn, ref, port)


def _vlm_batch(cr, B=2, T=12, seed=4):
    """A qwen2-vl batch with grid M-RoPE ids (3, B, V + T) and labels."""
    b = request_batch(cr, B, cr.vision_tokens + T,
                      np.random.default_rng(seed))
    b["labels"] = np.random.default_rng(seed + 1).integers(
        0, cr.vocab_size, (B, T)).astype(np.int32)
    return b


def test_grad_accum_matches_reference_and_one_big_batch():
    cr, *_ = train_setup("qwen2-vl-7b")
    batch = _vlm_batch(cr)
    assert batch["mrope_positions"].shape[:2] == (3, 2)
    _, pn, ref2, port2 = adamw_step_both("qwen2-vl-7b", batch, grad_accum=2)
    assert_adamw_step_close(pn, ref2, port2)
    _, _, _, port1 = adamw_step_both("qwen2-vl-7b", batch, grad_accum=1)
    # both microbatches hold 12 labels each, so the mean of their losses
    # is the whole batch's: the same within the fp32 tolerance
    assert abs(float(port2[2]["loss"]) - float(port1[2]["loss"])) <= \
        LOSS_RTOL32 * abs(float(port1[2]["loss"]))
    assert_adamw_step_close(pn, port1, port2)


def test_grad_accum_must_divide_the_batch():
    _, ct, pn, _ = train_setup("qwen2-7b", masked=False)
    tp = transformer_params_from_reference(pn)
    opt = adamw(constant(LR))
    step = make_train_step(ct, opt, grad_accum=3, device="cpu")
    with pytest.raises(ValueError, match="grad_accum 3"):
        step(tp, opt.init(tp), train_batch_np(ct, 2, 6))


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-7b", "float32"), ("qwen2-7b", "bfloat16"),
    ("mixtral-8x7b", "float32"), ("deepseek-v3-671b", "float32"),
    ("zamba2-1.2b", "float32"), ("qwen2-vl-7b", "bfloat16"),
    ("hubert-xlarge", "bfloat16")])
def test_remat_changes_no_bit(arch, dtype, monkeypatch):
    """Loss, metrics and every gradient equal with ``remat`` on and off;
    with it on, every attention (or MoE) block and every Mamba2 block runs
    twice (the MTP block, outside the stack, once)."""
    _, ct, pn, mn = train_setup(arch, dtype=dtype)
    batch = port_batch(train_batch_np(ct, 2, 12))
    masks = transformer_masks_from_reference(mn)
    calls = {"attn": 0, "ssm": 0}
    for name, kind in (("_attn_block", "attn"), ("_ssm_block", "ssm")):
        real = getattr(ttr, name)

        def counted(*a, _real=real, _kind=kind):
            calls[_kind] += 1
            return _real(*a)
        monkeypatch.setattr(ttr, name, counted)
    out = {}
    for remat in (False, True):
        calls.update(attn=0, ssm=0)
        out[remat] = port_loss_and_grads(
            ct.replace(remat=remat), transformer_params_from_reference(pn),
            batch, masks)
        out[remat] = out[remat] + (dict(calls),)
    (l0, m0, g0, c0), (l1, m1, g1, c1) = out[False], out[True]
    assert torch.equal(l0, l1) and m0 == m1
    flat0 = jax.tree_util.tree_leaves(transformer_params_to_reference(g0))
    flat1 = jax.tree_util.tree_leaves(transformer_params_to_reference(g1))
    for a, b in zip(flat0, flat1):
        assert np.array_equal(np.asarray(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))
    mtp = 1 if ct.mtp_depth else 0
    assert c1["attn"] == 2 * (c0["attn"] - mtp) + mtp and c0["attn"] > mtp
    assert c1["ssm"] == 2 * c0["ssm"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hubert-xlarge",
                                  "deepseek-v3-671b"])
def test_pruned_units_get_exact_zero_gradients(arch, dtype):
    """The FFN channels, GQA heads (and the KV heads of groups pruned
    whole) and MLA heads the masks prune get gradients of exactly zero;
    the kept ones do not."""
    _, ct, pn, mn = train_setup(arch, dtype=dtype)
    masks = transformer_masks_from_reference(mn)
    _, _, grads = port_loss_and_grads(
        ct, transformer_params_from_reference(pn),
        port_batch(train_batch_np(ct, 2, 12)), masks)
    pruned = smoke.pruned_grads(ct, grads, masks)
    assert pruned and sum(t.numel() for t in pruned) > 0
    assert not any(t.any() for t in pruned)
    run = grads["runs"][0]
    kept = (masks[0]["ffn_mask"][0] > 0)
    assert run["mlp"]["w_up"][0][:, kept].abs().sum() > 0


@pytest.mark.parametrize("vocab,seed,step", [(512, 0, 0), (152064, 0, 3),
                                             (504, 7, 1)])
def test_markov_tokens_bit_equal_to_reference(vocab, seed, step):
    got = TMarkov(vocab, seed=seed).batch(2, 33, step)
    want = RMarkov(vocab, seed=seed).batch(2, 33, step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_batch_on_moves_labels_as_int64():
    _, ct, _, _ = train_setup("qwen2-vl-7b", masked=False)
    b = batch_on(torch.device("cpu"), ct, _vlm_batch(ct))
    assert b["labels"].dtype == torch.long
    assert b["mrope_positions"].dtype == torch.int32


def test_train_steps_lower_the_loss_on_the_cpu():
    """Four AdamW steps on one fixed ``MarkovTokens`` batch of the smoke
    Qwen2-7B, masked, remat on: the loss falls."""
    _, ct, pn, mn = train_setup("qwen2-7b", remat=True)
    tp = transformer_params_from_reference(pn)
    opt = adamw(constant(1e-3))
    step = make_train_step(ct, opt, transformer_masks_from_reference(mn),
                           device="cpu")
    batch = TMarkov(ct.vocab_size).batch(2, 16, 0)
    state = opt.init(tp)
    losses = []
    for _ in range(4):
        tp, state, metrics = step(tp, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))
