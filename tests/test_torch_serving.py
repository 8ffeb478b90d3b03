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
from repro_torch.core.collab.protocol import affine_qparams
from repro_torch.models.cnn import cnn_abs_bound
from torch_parity import fp32_tol, port_params, ref_tree, tiny_setup

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


def _codec_bound(sess, split, image):
    """Elementwise bound on the logit gap one int8 codec step at the
    split can cause: the two packages' edge outputs differ by fp32
    rounding, so a code may land one step apart (step = the frame's
    scale); ``cnn_abs_bound`` carries a one-step perturbation of every
    element through the cloud half."""
    bank = sess._runner._bank
    edge, _, _ = bank.get(split)
    with torch.no_grad():
        feat = edge(torch.from_numpy(image)) if edge else \
            torch.from_numpy(image)
    scale, _ = affine_qparams(float(feat.min()), float(feat.max()), 255)
    delta = torch.full_like(feat, scale)
    with torch.no_grad():
        return cnn_abs_bound(bank._tparams, bank.deploy_cfg, delta,
                             masks=bank._masks, start_layer=split).numpy()


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
                    bound = _codec_bound(t_sess, split, img)
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
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    plan = tserving.DeploymentPlan.from_args(
        port_params(params), cfg_t, 6, masks=masks, compact=True,
        adaptive=AdaptivePolicy(candidates=(3, 6)).to_json())
    with pytest.raises(NotImplementedError, match="adaptive"):
        tserving.connect(plan, backend="local", device="cpu")
    plain = tserving.DeploymentPlan.from_args(port_params(params), cfg_t, 6)
    with pytest.raises(NotImplementedError, match="streaming"):
        tserving.connect(plain, backend="streaming", device="cpu")
    with pytest.raises(ValueError):
        tserving.connect(plain, backend="carrier-pigeon", device="cpu")
    with pytest.raises(NotImplementedError, match="energy"):
        tserving.DeploymentPlan.from_args(port_params(params), cfg_t, None,
                                          energy={"profile": "mcu"})


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
