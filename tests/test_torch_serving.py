"""The slice as a whole: ``repro.serving.connect(plan, "local")`` against
``repro_torch.serving.connect(plan, "local", device="cpu")`` on the same
plan and images, at splits 0 (all cloud) through N (all edge), for the
fp32 and int8 wire codecs, with and without the int8 quantized edge."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import serving as rserving
from repro.core.collab.adaptive import AdaptivePolicy
from repro_torch import serving as tserving
from torch_parity import (codec_bound, fp32_tol, port_params, ref_tree,
                          tiny_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

SPLITS = (0, 3, 10, 13)          # 13 = N: every layer on the edge


def _pair(split, codec, quant, compact=True, pack=False):
    cfg_r, cfg_t, params, masks, x = tiny_setup(batch=1)
    kw = dict(masks=masks, compact=compact, codec=codec, pack=pack)
    q_r = q_t = None
    if quant:
        # backend="pallas": the reference runs its Pallas kernel (forced
        # to interpret mode on the CPU), the port its kernel's wrapper
        q_r = rserving.QuantPolicy(weight_bits=8, backend="pallas")
        q_t = tserving.QuantPolicy(weight_bits=8, backend="pallas")
    p_r = rserving.DeploymentPlan.from_args(ref_tree(params), cfg_r, split,
                                            quant=q_r, **kw)
    p_t = tserving.DeploymentPlan.from_args(port_params(params), cfg_t,
                                            split, quant=q_t, **kw)
    assert p_t.digest == p_r.digest
    return p_r, p_t


def _images(n=2):
    rng = np.random.default_rng(11)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32edge", "int8edge"])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_local_session_matches_reference(codec, quant):
    for split in SPLITS:
        p_r, p_t = _pair(split, codec, quant)
        r_sess = rserving.connect(p_r, backend="local")
        with tserving.connect(p_t, backend="local", device="cpu") as t_sess:
            for img in _images():
                want = r_sess.infer(img)
                got = t_sess.infer(img)
                # wire bytes and the analytic Eq. 5 terms: exactly equal
                assert got["tx_bytes"] == want["tx_bytes"], split
                assert got["t_edge"] == want["t_edge"], split
                assert got["t_upstream"] == want["t_upstream"], split
                assert got["fault"] == want["fault"]
                assert set(want) <= set(got)
                lw, lg = np.asarray(want["logits"]), got["logits"]
                assert lg.shape == lw.shape and np.isfinite(lg).all()
                if codec == "fp32" or split in (0, len(p_t.cfg.layers)):
                    np.testing.assert_allclose(lg, lw, rtol=0,
                                               atol=fp32_tol(lw))
                else:
                    bound = codec_bound(t_sess._runner._bank, split, img)
                    assert (np.abs(lg - lw)
                            <= bound + fp32_tol(lw)).all(), split
                    assert lg.argmax(-1).tolist() == \
                        lw.argmax(-1).tolist(), split


def test_masked_packed_plan_matches_reference():
    """A masked-but-dense plan (``compact=False``) with channel packing:
    the masks run inside the edge and cloud halves and only the live
    channels cross the wire."""
    p_r, p_t = _pair(3, "fp32", quant=True, compact=False, pack=True)
    r_sess = rserving.connect(p_r, backend="local")
    t_sess = tserving.connect(p_t, backend="local", device="cpu")
    for img in _images():
        want, got = r_sess.infer(img), t_sess.infer(img)
        assert got["tx_bytes"] == want["tx_bytes"]
        assert got["t_upstream"] == want["t_upstream"]
        lw = np.asarray(want["logits"])
        np.testing.assert_allclose(got["logits"], lw, rtol=0,
                                   atol=fp32_tol(lw))


def test_unported_section_and_backend_raise():
    """No plan section is refused any more (the test keeps the name of the
    refusal it replaced): an ``adaptive`` plan connects; a ``fleet`` plan
    has the reference's digest and ``describe`` line and serves on the
    local and streaming backends with the bare plan's logits and
    ``tx_bytes``, bit for bit; an unknown backend raises; and
    ``from_args(split=None)`` with an ``energy`` section picks by the
    energy objective (the reference's split)."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    plan = tserving.DeploymentPlan.from_args(
        port_params(params), cfg_t, 6, masks=masks, compact=True,
        adaptive=AdaptivePolicy(candidates=(3, 6)).to_json())
    assert isinstance(plan.adaptive, tserving.AdaptivePolicy)
    with tserving.connect(plan, backend="local", device="cpu") as sess:
        assert sess.infer(_images(1)[0])["logits"].shape == (1, 7)
    plain = tserving.DeploymentPlan.from_args(port_params(params), cfg_t, 6)
    sc = tserving.FleetScenario(name="orchard", seed=7, n_edges=4,
                                n_cloudlets=1)
    kw = dict(masks=masks, compact=True, codec="int8")
    bare = tserving.DeploymentPlan.from_args(port_params(params), cfg_t, 6,
                                             **kw)
    fleet = tserving.DeploymentPlan.from_args(port_params(params), cfg_t, 6,
                                              fleet=sc, **kw)
    want = rserving.DeploymentPlan.from_args(
        ref_tree(params), cfg_r, 6, fleet=rserving.FleetScenario.from_json(
            sc.to_json()), **kw)
    assert fleet.digest == want.digest != bare.digest
    assert fleet.describe() == want.describe()
    images = _images(3)
    for backend, extra in (("local", {}),
                           ("streaming", {"realtime_channel": False})):
        with tserving.connect(bare, backend, device="cpu", **extra) as b, \
                tserving.connect(fleet, backend, device="cpu",
                                 **extra) as f:
            for w, g in zip(b.infer_many(images), f.infer_many(images)):
                assert np.array_equal(g["logits"], w["logits"]), backend
                assert g["tx_bytes"] == w["tx_bytes"], backend
    with pytest.raises(ValueError):
        tserving.connect(plain, backend="carrier-pigeon", device="cpu")
    energy = tserving.EnergyPolicy(profile=tserving.MCU_ENERGY,
                                   energy_weight_s_per_j=0.5)
    got = tserving.DeploymentPlan.from_args(port_params(params), cfg_t,
                                            None, masks=masks, compact=True,
                                            energy=energy)
    want = rserving.DeploymentPlan.from_args(
        ref_tree(params), cfg_r, None, masks=masks, compact=True,
        energy=rserving.EnergyPolicy.from_json(energy.to_json()))
    assert got.split == want.split and got.digest == want.digest


def test_measured_timing_reports_the_wallclock():
    """``simulate_compute=False`` reports each half's measured seconds
    instead of the Eq. 5 model; the uplink stays the modeled send."""
    _, p_t = _pair(10, "int8", quant=True)
    sess = tserving.connect(p_t, backend="local", device="cpu",
                            simulate_compute=False)
    res = sess.infer(_images(1)[0])
    link = p_t.profile.link
    assert res["t_edge"] == res["wallclock"]["edge"]
    t_tx = res["tx_bytes"] / link.bandwidth + link.rtt_s
    assert res["t_upstream"] == pytest.approx(t_tx + res["wallclock"]["cloud"],
                                              rel=1e-9)
