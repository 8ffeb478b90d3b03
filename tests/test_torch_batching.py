"""The port's dynamic batching: batched logits bit-identical to sequential
batch-1 logits (``CollabRunner.infer_batch``, ``DynamicBatcher``, the
local session's ``infer_many`` and concurrent socket sessions against a
batching ``CloudServer``), the plan policies' JSON against the
reference's, the bucket rules and ``pad_rows``, and ``n_traces`` steady
after ``warm``. All on the CPU at the tiny size."""
from __future__ import annotations

import threading

import numpy as np
import pytest

from repro.core.collab import batching as rb
from repro.core.collab import cluster as rcl
from repro.core.collab import faults as rf
from repro_torch import serving as tserving
from repro_torch.core.collab import batching as tb
from repro_torch.core.collab import cluster as tcl
from repro_torch.core.collab import faults as tf
from repro_torch.core.collab.runtime import (CollabRunner, SplitFnBank,
                                             _warm_input)
from torch_parity import free_port, port_params, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)

N_LAYERS = len(tiny_setup()[1].layers)


def _plan(split, quant=False, batching=None, **transport):
    _, cfg, params, masks, _ = tiny_setup()
    return tserving.DeploymentPlan.from_args(
        port_params(params), cfg, split, masks=masks, compact=True,
        codec="int8", shape_link=False, batching=batching,
        quant=tserving.QuantPolicy(weight_bits=8) if quant else None,
        **transport)


def _images(n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.view(np.uint32).tolist() == b.view(np.uint32).tolist()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32edge", "int8edge"])
@pytest.mark.parametrize("split", [0, 3, 6, N_LAYERS])
def test_infer_batch_bit_identical_to_sequential(split, quant):
    """Three requests through one row-mapped edge call and one cloud call,
    padded to a bucket of 4, give each request the bits of its own
    batch-1 ``infer``, and the same ``tx_bytes``."""
    plan = _plan(split, quant)
    runner = CollabRunner(plan.params, plan.cfg, split, plan.profile,
                          masks=plan.masks, compact=True, codec="int8",
                          quant=plan.quant, device="cpu")
    images = _images(3)
    seq = [runner.infer(im) for im in images]
    bat = runner.infer_batch(images)
    for s, b in zip(seq, bat):
        assert _same_bits(b["logits"], s["logits"])
        assert b["timing"].tx_bytes == s["timing"].tx_bytes


def test_dynamic_batcher_fuses_frames_bit_identical_to_sequential():
    """Four frames submitted to one lane fuse into one cloud call of four
    rows (the window is long, so the batch closes when it is full), and
    each future resolves to the bits of a batch-1 cloud call."""
    plan = _plan(6)
    bank = SplitFnBank(plan.params, plan.cfg, plan.masks, True,
                       device="cpu")
    edge, cloud, _ = bank.get(6)
    feats = [bank.call(edge, im) for im in _images(4)]
    engine = tb.DynamicBatcher(bank, tb.BatchingPolicy(max_batch=4,
                                                       max_wait_ms=60e3))
    try:
        futs = [engine.submit(6, "int8", f) for f in feats]
        got = [f.result(timeout=60) for f in futs]
    finally:
        engine.stop()
    for g, f in zip(got, feats):
        assert _same_bits(g, bank.call(cloud, f))
    (lane,) = engine.stats().values()
    assert (lane["frames"], lane["batches"], lane["rows"]) == (4, 1, 4)
    assert lane["batch_sizes"] == [4] and lane["pending"] == 0


def test_local_session_infer_many_batched_bit_identical():
    plan = _plan(6, quant=True, batching=tb.BatchingPolicy(max_batch=4))
    sess = tserving.connect(plan, backend="local", device="cpu")
    images = _images(6)
    many = sess.infer_many(images)
    for img, res in zip(images, many):
        one = sess.infer(img)
        assert _same_bits(res["logits"], one["logits"])
        assert res["tx_bytes"] == one["tx_bytes"]


def test_concurrent_socket_sessions_batched_equal_sequential():
    """Four socket sessions sending at once to one batching
    ``CloudServer``: every row's logits have the bits of the same image
    served sequentially by the local backend, and the server's lane
    accounting covers every request."""
    plan = _plan(6, quant=True,
                 batching=tb.BatchingPolicy(max_batch=4, max_wait_ms=20.0),
                 port=free_port())
    local = tserving.connect(plan, backend="local", device="cpu")
    images = {c: _images(4, seed=10 + c) for c in range(4)}
    got = {}

    def client(c):
        with tserving.connect(plan, backend="socket", device="cpu") as s:
            got[c] = [s.infer(im) for im in images[c]]
    with tserving.CloudServer(plan, max_clients=None,
                              device="cpu") as server:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in images]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    for c, ims in images.items():
        for im, res in zip(ims, got[c]):
            want = local.infer(im)
            assert _same_bits(res["logits"], want["logits"])
            assert res["tx_bytes"] == want["tx_bytes"]
    assert sum(s["rows"] for s in server.batch_stats.values()) == 16


POLICIES = {
    "batching_default": lambda m: m.BatchingPolicy(),
    "batching_buckets": lambda m: m.BatchingPolicy(max_batch=6,
                                                   max_wait_ms=0.5,
                                                   buckets=(1, 2, 6)),
    "batching_bounded": lambda m: m.BatchingPolicy(max_batch=4,
                                                   max_queue=3),
    "faults_default": lambda m: m.FaultPolicy(),
    "faults_fail": lambda m: m.FaultPolicy(max_retries=0,
                                           fallback="fail",
                                           heartbeat_s=0.25, seed=9),
    "routing": lambda m: m.RoutingPolicy(ports=(31001, 31002, 31003),
                                         dead_after_count=3,
                                         retry_dead_s=0.5),
}
_MODULES = {"batching": (rb, tb), "faults": (rf, tf), "routing": (rcl, tcl)}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_json_equals_reference(name):
    r_mod, t_mod = _MODULES[name.split("_")[0]]
    r_pol, t_pol = POLICIES[name](r_mod), POLICIES[name](t_mod)
    assert t_pol.to_json() == r_pol.to_json()
    cls_t, cls_r = type(t_pol), type(r_pol)
    assert cls_t.from_json(r_pol.to_json()).to_json() == r_pol.to_json()
    assert cls_r.from_json(t_pol.to_json()).to_json() == t_pol.to_json()


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(max_wait_ms=-1),
                                dict(max_batch=4, buckets=(1, 3)),
                                dict(max_batch=4, buckets=(2, 1, 4)),
                                dict(max_queue=0)])
def test_batching_policy_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        rb.BatchingPolicy(**kw)
    with pytest.raises(ValueError):
        tb.BatchingPolicy(**kw)


def test_buckets_and_pad_rows_equal_reference():
    for n in range(1, 20):
        assert tb.default_buckets(n) == rb.default_buckets(n)
        assert tb.next_pow2_bucket(n) == rb.next_pow2_bucket(n)
        for buckets in ((1, 2, 4, 8), (1, 3, 19), (19,)):
            if n <= buckets[-1]:
                assert tb.bucket_for(n, buckets) == rb.bucket_for(n, buckets)
            else:
                with pytest.raises(ValueError):
                    tb.bucket_for(n, buckets)
    xs = np.arange(24, dtype=np.float32).reshape(3, 2, 4)
    for bucket in (1, 3, 4, 8):
        got, want = tb.pad_rows(xs, bucket), rb.pad_rows(xs, bucket)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    rec_t, rec_r = tb.LaneStats((6, "int8", True)), rb.LaneStats(
        (6, "int8", True))
    assert rec_t.to_json() == rec_r.to_json()


def test_n_traces_steady_after_warm():
    """``warm`` over splits x buckets meets every shape the serving path
    then runs; a new bucket is a new shape."""
    plan = _plan(6, quant=True)
    bank = SplitFnBank(plan.params, plan.cfg, plan.masks, True,
                       quant=plan.quant, device="cpu")
    image = _warm_input(plan.cfg)
    bank.warm([3, 6], image, buckets=(1, 2, 4))
    warmed = bank.n_traces
    assert warmed > 0
    for split in (3, 6):
        edge, cloud, _ = bank.get(split)
        feat = bank.call(edge, image)
        bank.call(cloud, feat)
        for b in (2, 4):
            edge_b, cloud_b, _ = bank.get(split, batch_bucket=b)
            bank.call(edge_b, np.repeat(image, b, axis=0))
            bank.call(cloud_b, np.repeat(feat, b, axis=0))
    assert bank.n_traces == warmed
    _, cloud_b, _ = bank.get(6, batch_bucket=8)
    bank.call(cloud_b, np.repeat(bank.call(bank.get(6)[0], image), 8, 0))
    assert bank.n_traces == warmed + 1
