"""The streaming backend (``connect(plan, "streaming")``,
``StreamingCollabRunner``): three stage threads, bounded queues, the edge
stage fusing up to ``microbatch`` requests into one call and one frame.
Held bit for bit to the local backend (``microbatch`` 1) and to the
local backend's halves over the frames the stream formed (``microbatch``
4: a fused int8 frame is quantized with one scale, as in the reference),
and within tolerance of the reference's ``StreamingSession``."""
from __future__ import annotations

import importlib.util
import os
import threading

import numpy as np
import pytest

from repro import serving as rserving
from repro.core.collab import protocol as rprotocol
from repro_torch import serving as tserving
from repro_torch.core.collab import protocol as tprotocol
from torch_parity import (codec_bound, fp32_tol, port_params, ref_tree,
                          tiny_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

#: ``chip_smoke.py``'s helpers that rebuild a stream's frames
#: (``stream_frames``, ``stream_expected``): one reconstruction for the card
#: and for these tests
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

N_LAYERS = 13
#: (split, codec, compact, pack, quantized edge)
PLANS = {"int8_c10_quant": (10, "int8", True, False, True),
         "fp32_c3_packed": (3, "fp32", False, True, False),
         "int8_edge_only": (N_LAYERS, "int8", True, False, True),
         "int8_cloud_only": (0, "int8", True, False, False)}


def _plans(name):
    split, codec, compact, pack, quant = PLANS[name]
    cfg_r, cfg_t, params, masks, _ = tiny_setup(batch=1)
    kw = dict(masks=masks, compact=compact, codec=codec, pack=pack)
    q = {}
    if quant:
        q = dict(q_r=rserving.QuantPolicy(weight_bits=8, backend="pallas"),
                 q_t=tserving.QuantPolicy(weight_bits=8, backend="pallas"))
    p_r = rserving.DeploymentPlan.from_args(ref_tree(params), cfg_r, split,
                                            quant=q.get("q_r"), **kw)
    p_t = tserving.DeploymentPlan.from_args(port_params(params), cfg_t,
                                            split, quant=q.get("q_t"), **kw)
    assert p_t.digest == p_r.digest
    return p_r, p_t


def _images(n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("microbatch", [1, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_streamed_logits_are_the_local_backends_bit_for_bit(name,
                                                            microbatch):
    _, plan = _plans(name)
    images = _images()
    with tserving.connect(plan, backend="local", device="cpu") as local:
        want = local.infer_many(images)
    with tserving.connect(plan, backend="streaming", device="cpu",
                          realtime_channel=False,
                          microbatch=microbatch) as sess:
        got = sess.infer_many(images)
        frames = smoke.stream_frames(sess.last_report)
        bank = sess._runner._bank
        expected = smoke.stream_expected(bank.get(plan.split), bank.call,
                                         plan.codec, images, frames)
    assert len(got) == len(images)
    assert max(len(f) for f in frames) <= microbatch
    lossless = plan.codec == "fp32" or plan.split == N_LAYERS
    for i, (g, w, (logits, tx)) in enumerate(zip(got, want, expected)):
        assert _same_bits(g["logits"], logits), (name, i)
        assert g["tx_bytes"] == tx
        assert g["t_edge"] is None and g["e_edge_j"] is None
        if microbatch == 1 or lossless:
            assert _same_bits(g["logits"], w["logits"]), (name, i)
        if microbatch == 1 or plan.split == N_LAYERS:
            assert g["tx_bytes"] == w["tx_bytes"]


@pytest.mark.parametrize("name,microbatch", [("int8_c10_quant", 1),
                                             ("fp32_c3_packed", 4),
                                             ("int8_edge_only", 4)])
def test_streaming_session_matches_reference(name, microbatch):
    """The reference's ``StreamingSession`` on the same plan and images:
    logits within the fp32 tolerance where the codec is lossless (or no
    frame crosses), else within what one int8 code step at the split can
    move them (``codec_bound``), with the same argmax; one frame per
    request at ``microbatch`` 1, so ``tx_bytes`` equal."""
    p_r, p_t = _plans(name)
    images = _images(6)
    r_sess = rserving.connect(p_r, backend="streaming",
                              realtime_channel=False, microbatch=microbatch)
    want = r_sess.infer_many(images)
    with tserving.connect(p_t, backend="streaming", device="cpu",
                          realtime_channel=False,
                          microbatch=microbatch) as sess:
        got = sess.infer_many(images)
    for img, g, w in zip(images, got, want):
        lw = np.asarray(w["logits"])
        assert g["logits"].shape == lw.shape
        if p_t.codec == "fp32" or p_t.split == N_LAYERS:
            np.testing.assert_allclose(g["logits"], lw, rtol=0,
                                       atol=fp32_tol(lw))
        else:
            bound = codec_bound(sess._runner._bank, p_t.split, img)
            assert (np.abs(g["logits"] - lw) <= bound + fp32_tol(lw)).all()
            assert g["logits"].argmax(-1).tolist() == lw.argmax(-1).tolist()
        if microbatch == 1:
            assert g["tx_bytes"] == w["tx_bytes"]
        assert set(w) <= set(g)


def test_fused_int8_frames_match_the_reference():
    """At ``microbatch`` 4 an int8 frame fuses several requests under one
    scale, where the local backend quantizes each request alone. The
    reference's halves over the frames the port's stream formed (its edge
    on each request, its ``encode_feature`` on the concatenated frame, its
    cloud half on each decoded row): the port's logits within what one
    int8 code step of the frame's scale can move them (``codec_bound`` over
    the frame's requests) plus the fp32 tolerance, the same argmax, and
    the same ``tx_bytes``. That bound is loose (a worst case through the
    cloud half), so each fused frame is also held to the reference's own:
    the port's int8 frame of the port's edge rows, decoded, lies on the
    reference's grid for the reference's edge rows (``affine_qparams`` of
    their min and max: off the grid by at most 1e-3 of a step, where fp32
    rounding of the two edges gives ~5e-5) and within one step of the
    reference's decoded frame. The stream runs again (at most 5 times)
    until it has fused a frame, since which requests fuse depends on
    timing."""
    p_r, p_t = _plans("int8_c10_quant")
    images = _images()
    r_bank = rserving.connect(p_r, backend="streaming",
                              realtime_channel=False,
                              microbatch=4)._runner._bank
    with tserving.connect(p_t, backend="streaming", device="cpu",
                          realtime_channel=False, microbatch=4) as sess:
        for _ in range(5):
            got = sess.infer_many(images)
            frames = smoke.stream_frames(sess.last_report)
            if max(len(f) for f in frames) > 1:
                break
        bank = sess._runner._bank
        assert max(len(f) for f in frames) > 1, frames
        want = smoke.stream_expected(
            r_bank.get(p_r.split), lambda fn, x: np.asarray(fn(x)),
            p_r.codec, images, frames, protocol=rprotocol)
        r_edge, t_edge = r_bank.get(p_r.split)[0], bank.get(p_t.split)[0]
        for ids in frames:
            fr = np.concatenate([np.asarray(r_edge(images[i])) for i in ids])
            ft = np.concatenate([bank.call(t_edge, images[i]) for i in ids])
            scale, zero = rprotocol.affine_qparams(float(fr.min()),
                                                   float(fr.max()), 255)
            dec = tprotocol.decode_any(
                tprotocol.encode_feature(ft, codec=p_t.codec))[0]
            steps = (dec.astype(np.float64) - zero) / scale
            assert np.abs(steps - np.rint(steps)).max() <= 1e-3, ids
            dec_r = rprotocol.decode_any(
                rprotocol.encode_feature(fr, codec=p_r.codec))[0]
            assert np.abs(dec - dec_r).max() <= 1.001 * scale, ids
            bound = codec_bound(bank, p_t.split,
                                np.concatenate([images[i] for i in ids]))
            for i in ids:
                lw, tx = want[i]
                g = got[i]["logits"]
                assert g.shape == lw.shape
                assert (np.abs(g - lw) <= bound + fp32_tol(lw)).all(), i
                assert g.argmax(-1).tolist() == lw.argmax(-1).tolist()
                assert got[i]["tx_bytes"] == tx


def test_stream_report_accounts_every_request():
    _, plan = _plans("int8_c10_quant")
    images = _images(7)
    with tserving.connect(plan, backend="streaming", device="cpu",
                          realtime_channel=False, microbatch=3,
                          queue_depth=2) as sess:
        out = sess.infer_many(images)
        rep = sess.last_report
    assert set(rep.occupancy) == set(rep.stages) == {"edge", "tx", "cloud"}
    frames = smoke.stream_frames(rep)
    for st in rep.stages.values():
        assert st.items == len(images)
        assert st.batches == len(frames)
        assert st.busy_s >= 0
    assert rep.throughput_rps > 0 and rep.wall_s > 0
    assert rep.tx_bytes_total == int(sum(r["tx_bytes"] for r in rep.results))
    assert [o["tx_bytes"] for o in out] == [int(r["tx_bytes"])
                                            for r in rep.results]


def test_realtime_channel_sleeps_each_frames_modeled_cost():
    """The port's ``SimChannel`` never sleeps; with ``realtime_channel``
    the tx stage sleeps each frame's modeled cost, so its busy time is at
    least the modeled total."""
    _, plan = _plans("int8_c10_quant")
    with tserving.connect(plan, backend="streaming", device="cpu",
                          realtime_channel=True) as sess:
        sess.infer_many(_images(3))
        rep = sess.last_report
    modeled = sum(r["t_tx_model"] for r in rep.results)
    assert modeled > 0
    assert rep.stages["tx"].busy_s >= modeled


def test_a_failing_stage_raises_instead_of_hanging():
    """A stage that raises ends the stages after it and drains its input,
    so the producer and the earlier stages never block on a full queue;
    ``infer_many`` raises the error."""
    _, plan = _plans("int8_c10_quant")
    sess = tserving.connect(plan, backend="streaming", device="cpu",
                            realtime_channel=False, queue_depth=1)

    def broken(x):
        raise RuntimeError("cloud half failed")
    sess._runner._cloud_fn = broken
    caught = []

    def run():
        try:
            sess.infer_many(_images(12))
        except RuntimeError as e:
            caught.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert caught and "cloud half failed" in str(caught[0])
