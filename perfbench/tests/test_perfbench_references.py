"""The plain references agree with the port at small sizes on the CPU,
and every cell's whole run (the look for a card skipped) comes out
correct."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench.lib import cnn, lm, seeded
from perfbench.references import cnn as cnn_ref
from perfbench.references import transformer as lm_ref
from perfbench.tests import perfbench_tiny as tiny


def test_transformer_reference_matches_the_port_forward_in_fp32():
    from repro_torch.models import transformer as tr
    f = tiny.files("qwen2-7b.prefill-replay")
    cfg = dict(f["config"], torch_dtype="float32")
    model = lm.build(cfg, 2**31 + 3, "cpu")
    tokens = seeded.token_batches(model.m["V"], 2, [40], 5, "cpu")[0]
    with tiny.threads(1):
        want, _ = tr.forward(model.params, model.pcfg, {"tokens": tokens},
                             masks=model.pmasks, backend="ref")
        got = lm_ref.logits(model.w, model.masks, model.m, tokens,
                            range(40))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cnn_reference_matches_the_port_uncompacted_and_compacted():
    from repro_torch.models.cnn import cnn_apply, compact_params
    f = tiny.files("alexnet-pv38.finetune-b128")
    model = cnn.build(f["config"], 9, "cpu")
    x, _ = seeded.leaf_images(3, 64, 38, 9, "cpu")
    with tiny.threads(1):
        want = cnn_apply(model.params, model.pcfg, x, masks=model.masks)
        got = cnn_ref.run({int(k[1:]): v for k, v in model.params.items()},
                          model.layers, x, 0, len(model.layers),
                          masks=model.masks)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        cparams, ccfg = compact_params(model.params, model.pcfg,
                                       model.masks)
        cl = cnn_ref.compact(model.layers, model.w, model.masks)
        torch.testing.assert_close(
            cnn_ref.run(cl, model.layers, x, 0, len(model.layers)),
            cnn_apply(cparams, ccfg, x), rtol=1e-5, atol=1e-5)


def test_affine_codes_are_the_wire_codec():
    from repro_torch.core.collab.protocol import (decode_feature,
                                                  encode_feature)
    x = torch.randn(3, 6, 6, 5, generator=torch.Generator().manual_seed(1))
    buf = encode_feature(x.numpy(), codec="int8")
    want, _ = decode_feature(buf)
    assert torch.equal(cnn_ref.affine_codes(x, 255), torch.from_numpy(want))
    assert len(buf) == cnn_ref.frame_bytes((6, 6, 5), 3)


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_whole_run_is_correct(cell):
    with tiny.threads(1):
        out = tiny.run_cell(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_decode_goes_round_its_cache_and_stays_correct(monkeypatch):
    """A window longer than the cache's free slots starts the answers
    again from the prompts' cache: the second pass repeats the first, and
    the check covers both."""
    f = tiny.files("qwen2-7b.decode-b64")
    drv = harness.driver(f["traffic"])
    clock = tiny.Clock()
    monkeypatch.setattr(drv, "time", clock)
    run = harness.Run(f["cell"], f["config"], f["traffic"], f["limits"],
                      2**31 + 5, 0.1, False, device="cpu")
    with tiny.threads(1):
        state = drv.setup(run)
        run.deadline = clock.perf_counter() + 0.1
        drv.window(state, run)
        drv.free(state)
        checks = drv.check(state, run)
    n = state["n"]
    assert state["first_pass"] is not None
    assert state["steps"] > state["gen"].shape[1] > n > 1
    assert torch.equal(state["gen"][:, :n], state["first_pass"][:, :n])
    assert checks["max_gap"] <= f["limits"]["checks"]["max_gap"]
