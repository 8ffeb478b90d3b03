"""Plans with ``adaptive`` and ``energy`` sections served by the port on
the CPU, held to the reference serving the same plan:

* the local backend on a degrading link trace and on a draining battery:
  the same switch list (every ``SplitSwitch`` field), ``e_edge_j`` within
  1e-12 relative, logits within fp32 tolerance of the reference's and bit
  for bit the port's fixed-split session's at the split each request ran
  at;
* RESPLIT on a live socket between a port peer and a JAX peer, both
  directions, decided by the edge's controller; a split outside the
  plan's candidates is refused by either package's cloud and the
  connection survives;
* an outage: the edge-only fallback moves the controller to the latest
  candidate, and a healed cloud pulls it back;
* the streaming backend's ``e_edge_j`` at ``microbatch`` 4 (the RTT split
  over a fused frame's requests);
* the result keys of the three backends.

Servers listen on ports the OS assigns; nothing asserts wall-clock time.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from repro import serving as rserving
from repro.core.partition import energy_model as rem
from repro.core.partition import profiles as rprof
from repro_torch import serving as tserving
from repro_torch.core.partition import energy_model as tem
from repro_torch.core.partition import profiles as tprof
from torch_parity import fp32_tol, free_port, port_params, ref_tree, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)

#: ``chip_smoke.py``'s ``ran_at`` (the split each request ran at, from a
#: switch list): one reconstruction for the card and for these tests
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

N = len(tiny_setup()[1].layers)
REF_KEYS = {"logits", "t_edge", "t_upstream", "t_total", "tx_bytes",
            "e_edge_j", "fault"}


def _profile(mod, mbps=50.0, rtt_s=1e-3, edge="MCU_EDGE"):
    return mod.TwoTierProfile(getattr(mod, edge), mod.PAPER_SERVER,
                              mod.LinkProfile("test", mbps * 1e6 / 8, rtt_s))


def _plans(split, adaptive=None, energy=None, quant=False,
           shape_link=False, **kw):
    """The same contract built by both packages (equal digests);
    ``adaptive`` the policy knobs, ``energy`` the ``EnergyPolicy`` knobs
    with the profile by name."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    out = []
    for serving, prof, em, cfg, p in (
            (rserving, rprof, rem, cfg_r, ref_tree(params)),
            (tserving, tprof, tem, cfg_t, port_params(params))):
        extra = {}
        if adaptive is not None:
            extra["adaptive"] = serving.AdaptivePolicy(**adaptive)
        if energy is not None:
            extra["energy"] = em.EnergyPolicy(
                profile=em.ENERGY_PROFILES[energy["profile"]],
                **{k: v for k, v in energy.items() if k != "profile"})
        if quant:
            extra["quant"] = serving.QuantPolicy(weight_bits=8,
                                                 backend="pallas")
        out.append(serving.DeploymentPlan.from_args(
            p, cfg, split, masks=masks, compact=True, codec="fp32",
            shape_link=shape_link, profile=_profile(prof), **extra, **kw))
    assert out[0].digest == out[1].digest
    assert out[0].describe() == out[1].describe()
    return out


def _images(n, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


LOCAL_CASES = {
    # a link that collapses from 50 to 2 Mbps 80 ms in (the virtual
    # clock of the trace); the int8 quantized edge
    "degrading_trace": dict(
        split=0, adaptive=dict(candidates=(0, 3, 6, 13), ewma_alpha=0.5,
                               min_samples=2, hysteresis=0.05, dwell=2),
        energy=dict(profile="mcu"), quant=True, trace=True, requests=24),
    # a battery small enough to drain within the run
    "battery_drain": dict(
        split=0, adaptive=dict(candidates=(0, 3, 13), ewma_alpha=0.5,
                               min_samples=2, hysteresis=0.01, dwell=2),
        energy=dict(profile="mcu", energy_weight_s_per_j=0.1,
                    battery_j=0.05), quant=False, trace=False, requests=40),
}


@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_local_adaptive_session_matches_reference(case):
    spec = LOCAL_CASES[case]
    p_r, p_t = _plans(spec["split"], spec["adaptive"], spec["energy"],
                      quant=spec["quant"])
    opts_r, opts_t = {}, {"device": "cpu"}
    if spec["trace"]:
        segs = [(0.08, 50.0), (float("inf"), 2.0)]
        opts_r["trace"] = rprof.LinkTrace.from_mbps("degrade", segs,
                                                    rtt_ms=1.0)
        opts_t["trace"] = tprof.LinkTrace.from_mbps("degrade", segs,
                                                    rtt_ms=1.0)
    r_sess = rserving.connect(p_r, backend="local", **opts_r)
    t_sess = tserving.connect(p_t, backend="local", **opts_t)
    images = [_images(4)[i % 4] for i in range(spec["requests"])]
    want = [r_sess.infer(img) for img in images]
    got = [t_sess.infer(img) for img in images]
    assert [vars(s) for s in t_sess.switches] == \
        [vars(s) for s in r_sess.switches]
    assert t_sess.switches, "the controller never switched"
    assert t_sess.split == r_sess.split != spec["split"]
    for w, g in zip(want, got):
        assert set(g) - {"wallclock"} == set(w) == REF_KEYS
        assert g["tx_bytes"] == w["tx_bytes"]
        assert g["t_edge"] == w["t_edge"]
        assert g["e_edge_j"] == pytest.approx(w["e_edge_j"], rel=1e-12)
        lw = np.asarray(w["logits"])
        np.testing.assert_allclose(g["logits"], lw, rtol=0,
                                   atol=fp32_tol(lw))
    # each request bit for bit the port's fixed-split session at its split
    ran = smoke.ran_at(t_sess.switches, spec["split"], len(images))
    fixed = {}
    for split in sorted(set(ran)):
        plan = tserving.DeploymentPlan.from_args(
            p_t.params, p_t.cfg, split, masks=p_t.masks, compact=True,
            codec="fp32", shape_link=False, profile=p_t.profile,
            quant=p_t.quant)
        fixed[split] = tserving.connect(plan, backend="local", device="cpu")
    for img, split, g in zip(images, ran, got):
        res = fixed[split].infer(img)
        assert res["logits"].tobytes() == g["logits"].tobytes(), split
        assert res["tx_bytes"] == g["tx_bytes"], split
    if case == "battery_drain":
        ctl = t_sess._controller
        assert ctl.battery_j < spec["energy"]["battery_j"]
        assert ctl.battery_j == r_sess._controller.battery_j
        for sw in t_sess.switches:
            assert sw.predicted_E < sw.current_E


ADAPTIVE = dict(candidates=(0, 3, 6, 13), ewma_alpha=0.5, min_samples=2,
                hysteresis=0.05, dwell=2)


@pytest.mark.parametrize("edge", ["port", "reference"])
def test_socket_resplit_between_packages(edge):
    """The edge's uplink is shaped to the plan's 50 Mbps, so its
    controller measures that link (the shaper's modeled cost of each
    send, not the host's clock), on which the weak edge offloads: a
    RESPLIT on the live connection to the other package's cloud, which
    serves the new split; a manual RESPLIT to a split outside the
    candidates is refused and the connection keeps serving."""
    p_r, p_t = _plans(6, ADAPTIVE, dict(profile="mcu"), shape_link=True,
                      port=free_port())
    images = _images(6)
    if edge == "port":
        server = rserving.CloudServer(p_r, max_clients=None)
        session = lambda: tserving.connect(p_t, backend="socket",  # noqa
                                           device="cpu")
        mismatch = tserving.PlanMismatchError
    else:
        server = tserving.CloudServer(p_t, max_clients=None, device="cpu")
        session = lambda: rserving.connect(p_r, backend="socket")  # noqa
        mismatch = rserving.PlanMismatchError
    local = rserving.connect(p_r, backend="local")
    with server:
        with session() as sess:
            sock = sess._client.sock
            ran, got = [], []
            for img in images:
                ran.append(sess.split)
                got.append(sess.infer(img))
            assert sess.switches and sess.switches[0].old_split == 6
            assert sess._client.sock is sock      # no reconnect
            with pytest.raises(mismatch, match="resplit"):
                sess.resplit(5)
            before = sess.split
            after = sess.infer(images[0])
            assert sess.split == before
            ran.append(before)
            got.append(after)
            images = images + images[:1]
    for img, split, res in zip(images, ran, got):
        local._runner.set_split(split)
        lw = np.asarray(local.infer(img)["logits"])
        if split == N:
            continue            # c=N: the logits cross the wire
        np.testing.assert_allclose(res["logits"], lw, rtol=0,
                                   atol=fp32_tol(lw))
        assert res["e_edge_j"] is not None and res["e_edge_j"] > 0
        assert res["fault"]["retries"] == 0


@pytest.mark.parametrize("cloud", ["port", "reference"])
def test_outage_moves_the_controller_to_the_latest_candidate(cloud):
    """A dead cloud: the request falls back to the edge, the controller
    collapses its estimate and adopts the latest candidate locally; a
    healed cloud serves again (reconnect, re-RESPLIT) and the healthy
    observations pull the split back to offloading. The uplink is shaped,
    so each observation is the modeled link, not the host's clock."""
    weak = dict(edge="MCU_EDGE", mbps=100.0, rtt_s=1e-4)
    pol = dict(candidates=(6, N), ewma_alpha=1.0, min_samples=1,
               hysteresis=0.0, dwell=1)
    faults = dict(max_retries=1, backoff_base_s=0.01, backoff_max_s=0.05,
                  backoff_jitter=0.0, request_deadline_s=5.0)
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    p_r = rserving.DeploymentPlan.from_args(
        ref_tree(params), cfg_r, 6, masks=masks, compact=True,
        codec="fp32", shape_link=True, port=free_port(),
        profile=_profile(rprof, **weak),
        adaptive=rserving.AdaptivePolicy(**pol),
        faults=rserving.FaultPolicy(**faults))
    p_t = tserving.DeploymentPlan.from_args(
        port_params(params), cfg_t, 6, masks=masks, compact=True,
        codec="fp32", shape_link=True, port=p_r.port,
        profile=_profile(tprof, **weak),
        adaptive=tserving.AdaptivePolicy(**pol),
        faults=tserving.FaultPolicy(**faults))
    assert p_r.digest == p_t.digest

    def server():
        if cloud == "port":
            return tserving.CloudServer(p_t, max_clients=None, device="cpu")
        return rserving.CloudServer(p_r, max_clients=None)
    x = _images(1)[0]
    want = np.asarray(rserving.connect(p_r, backend="local").infer(x)
                      ["logits"])
    srv = server()
    sess = tserving.connect(p_t, backend="socket", device="cpu",
                            sleep_fn=lambda s: None)
    try:
        assert sess.infer(x)["fault"]["fallback"] is False
        srv.kill()
        res = sess.infer(x)                          # outage: edge-only
        assert res["fault"]["fallback"] is True
        assert res["tx_bytes"] == 0
        np.testing.assert_allclose(res["logits"], want, rtol=0,
                                   atol=fp32_tol(want))
        assert sess.split == N
        assert sess.switches[-1].new_split == N
        assert sess._controller.split == N
        with server():                                # the link heals
            healed = sess.infer(x)
            assert healed["fault"]["fallback"] is False
            again = sess.infer(x)
            assert again["fault"] == {"faults": 0, "retries": 0,
                                      "migrations": 0, "fallback": False}
            assert sess.split == 6
            np.testing.assert_allclose(again["logits"], want, rtol=0,
                                       atol=fp32_tol(want))
    finally:
        sess.close()


def test_streaming_energy_splits_the_rtt_over_a_frame():
    """At ``microbatch`` 4 each request's joules price the stages' busy
    time amortized over the stream and its share of its frame's modeled
    uplink, with the frame's one RTT split over its requests, so the
    radio-active time stays positive."""
    _, p_t = _plans(6, energy=dict(profile="mcu"))
    sess = tserving.connect(p_t, backend="streaming", device="cpu",
                            realtime_channel=False, microbatch=4,
                            queue_depth=8)
    images = [_images(4)[i % 4] for i in range(16)]
    res = sess.infer_many(images)
    rep = sess.last_report
    assert any(r["frame_n"] > 1 for r in rep.results)
    rtt = p_t.profile.link.rtt_s
    n = len(rep.results)
    t_edge = rep.stages["edge"].busy_s / n
    t_cloud = rep.stages["cloud"].busy_s / n
    for got, r in zip(res, rep.results):
        want = tem.MCU_ENERGY.request_energy(
            t_edge, r["t_tx_model"], t_cloud, rtt_s=rtt / r["frame_n"])
        assert got["e_edge_j"] == want and want > 0
        assert r["t_tx_model"] - rtt / r["frame_n"] > 0
        assert got["t_edge"] is None and got["t_total"] is None


def test_result_keys_and_energy_across_backends():
    """On a metered plan every backend reports the reference's result
    keys (the local backend adds its ``wallclock``) with positive joules
    and the same wire bytes; the local backend's joules are the
    reference's and the analytic ``split_energy`` row's."""
    p_r, p_t = _plans(6, energy=dict(profile="mcu"), port=free_port())
    x = _images(1)[0]
    results = {"local": tserving.connect(p_t, backend="local",
                                         device="cpu").infer(x)}
    with tserving.CloudServer(p_t, max_clients=None, device="cpu"):
        with tserving.connect(p_t, backend="socket", device="cpu") as sess:
            results["socket"] = sess.infer(x)
    results["streaming"] = tserving.connect(
        p_t, backend="streaming", device="cpu",
        realtime_channel=False).infer(x)
    for name, res in results.items():
        assert set(res) - {"wallclock"} == REF_KEYS, name
        assert res["e_edge_j"] is not None and res["e_edge_j"] > 0, name
    assert "wallclock" in results["local"]
    assert (results["local"]["tx_bytes"] == results["socket"]["tx_bytes"]
            == results["streaming"]["tx_bytes"])
    want = rserving.connect(p_r, backend="local").infer(x)
    assert results["local"]["e_edge_j"] == pytest.approx(want["e_edge_j"],
                                                         rel=1e-12)
    from repro_torch.core.partition.latency_model import (
        cnn_input_bytes, compacted_cnn_layer_costs, wire_tx_scale)
    analytic = tem.split_energy(
        compacted_cnn_layer_costs(p_t.cfg, p_t.masks), 6, p_t.profile,
        tem.MCU_ENERGY, cnn_input_bytes(p_t.cfg),
        tx_scale=wire_tx_scale(p_t.cfg, p_t.masks, 6, codec="fp32",
                               compact=True))
    # the frame's codec header is not priced by the analytic model
    assert results["local"]["e_edge_j"] == pytest.approx(analytic["E_edge"],
                                                         rel=5e-3)
