"""A run whose timed path is broken underneath comes out not correct
(each fault a cell can have), and so does each cell's control."""
from __future__ import annotations

import pytest

from perfbench import control, harness
from perfbench.lib import lm
from perfbench.tests import perfbench_tiny as tiny


def _altered_tokens(make):
    """A step factory whose steps' logits are rolled by one along the
    vocabulary: every greedy token is the next id, not the best."""
    def factory(self, *args, **kw):
        step = make(self, *args, **kw)

        def altered(*a, **k):
            lg, cache = step(*a, **k)
            return lg.roll(1, -1), cache
        return altered
    return factory


@pytest.mark.parametrize("cell,method", [
    ("qwen2-7b.prefill-replay", "prefill_step"),
    ("qwen2-7b.prefill-replay", "decode_step"),
    ("qwen2-7b.decode-b64", "decode_step")])
def test_a_token_altered_where_it_is_produced(monkeypatch, cell, method):
    monkeypatch.setattr(lm.Model, method,
                        _altered_tokens(getattr(lm.Model, method)))
    with tiny.threads(1):
        out = tiny.run_cell(cell)
    assert not out["correct"], out["checks"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serving.session import StreamingSession
    infer_many = StreamingSession.infer_many

    def altered(self, images):
        outs = infer_many(self, images)
        outs[-1]["logits"] = outs[-1]["logits"] + 1.0
        return outs
    monkeypatch.setattr(StreamingSession, "infer_many", altered)
    with tiny.threads(1):
        out = tiny.run_cell("alexnet-pv38.stream-c13")
    assert not out["correct"], out["checks"]


def _wrapped_train_step(monkeypatch, wrap):
    import repro_torch.core.pipeline as pipeline
    make = pipeline.make_train_step
    monkeypatch.setattr(pipeline, "make_train_step",
                        lambda *a, **k: wrap(make(*a, **k)))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "unchanged_after_set_up"])
def test_a_train_step_at_fault(monkeypatch, fault):
    """``unchanged_after_set_up``: the first checked steps are sound, every
    later one returns its state unchanged."""
    calls = []

    def wrap(step):
        def faulty(params, opt_state, batch):
            calls.append(1)
            if fault == "unchanged" or (fault == "unchanged_after_set_up"
                                        and len(calls) > 3):
                _, _, loss = step(params, opt_state, batch)
                return params, opt_state, loss
            half = {k: v[:len(v) // 2] for k, v in batch.items()}
            return step(params, opt_state, half)
        return faulty
    _wrapped_train_step(monkeypatch, wrap)
    with tiny.threads(1):
        out = tiny.run_cell("alexnet-pv38.finetune-b128")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,seconds", [("qwen2-7b.prefill-replay", 0.1),
                                          ("qwen2-7b.decode-b64", 0.1),
                                          ("alexnet-pv38.stream-c13", 0.01)])
def test_the_control_fails_a_limit(monkeypatch, cell, seconds):
    f = tiny.files(cell)
    clock = tiny.Clock()
    monkeypatch.setattr(control, "time", clock)
    monkeypatch.setattr(harness.driver(f["traffic"]), "time", clock)
    with tiny.threads(1):
        r = control.readings(cell, 2**31 + 29, seconds, "precision", "cpu",
                             f)
    limits = f["limits"]["checks"]
    assert any(v > limits[k] for k, v in r["precision"].items()), r
    assert all(v <= limits[k] for k, v in r["program"].items()), r


def test_a_window_that_leaves_the_network_dead_reads_correct(monkeypatch):
    """A sound step on a network the window left dead (every parameter and
    the momentum zero: no unit active, no leaf but the last bias moves)
    is judged, not a crash."""
    import torch

    from perfbench.drivers import cnn_train
    after = cnn_train.after_window

    def dead(state, run):
        def zero(tree):
            return {k: {n: torch.zeros_like(t) for n, t in v.items()}
                    for k, v in tree.items()}
        state["params"] = zero(state["params"])
        state["opt"] = dict(state["opt"], mom=zero(state["opt"]["mom"]))
        after(state, run)
    monkeypatch.setattr(cnn_train, "after_window", dead)
    with tiny.threads(1):
        out = tiny.run_cell("alexnet-pv38.finetune-b128")
    assert out["correct"], out["checks"]


def test_a_window_that_leaves_the_state_not_finite_reads_not_correct(
        monkeypatch):
    """A window that left NaN in the parameters is judged not correct,
    with every number printed, not a crash without a result."""
    from perfbench.drivers import cnn_train
    after = cnn_train.after_window

    def nan(state, run):
        state["params"] = {k: {n: t.clone().fill_(float("nan"))
                               for n, t in v.items()}
                           for k, v in state["params"].items()}
        after(state, run)
    monkeypatch.setattr(cnn_train, "after_window", nan)
    with tiny.threads(1):
        out = tiny.run_cell("alexnet-pv38.finetune-b128")
    assert not out["correct"]
    window = {k: c["value"] for k, c in out["checks"].items()
              if k.startswith("window_")}
    assert window and all(v == cnn_train.NOT_FINITE for v in window.values())
