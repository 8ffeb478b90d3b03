"""The port's adaptive split controller against the reference's: both
packages' ``BandwidthEstimator`` and ``AdaptiveSplitController`` are
driven by one shared sequence of observations and events, and must decide
the same ``SplitSwitch`` list field by field, hold the same split, battery
and estimate after every step, and describe each switch in the same words.

The scenarios cover the hysteresis margin, the dwell window, an outage
(``note_outage``) and its heal-back, fleet backpressure
(``note_congestion``), a manual override (``note_external_switch``), the
battery drain and its urgency weight; then the policies' validation
errors and JSON. Only arithmetic runs (no model), on the tiny config and
full-width AlexNet with masks that keep half of every prunable layer."""
from __future__ import annotations

import dataclasses
import re
import threading

import numpy as np
import pytest

from repro.core.collab import adaptive as rad
from repro.core.partition import energy_model as rem
from repro.core.partition import profiles as rprof
from repro_torch.core.collab import adaptive as tad
from repro_torch.core.partition import energy_model as tem
from repro_torch.core.partition import profiles as tprof
from torch_parity import cnn_configs
from torch_parity import one_thread  # noqa: F401 (autouse)

#: scenario -> (edge compute profile, policy knobs, energy knobs or None);
#: every scenario starts at c=3 with candidates {0, 3, N//2, N-1, N}
SCENARIOS = {
    "degrading": ("PHONE_EDGE", dict(ewma_alpha=0.5, min_samples=2,
                                     hysteresis=0.05, dwell=2), None),
    "hysteresis_holds": ("PHONE_EDGE", dict(ewma_alpha=0.5, min_samples=2,
                                            hysteresis=0.95, dwell=1), None),
    "long_dwell": ("MCU_EDGE", dict(ewma_alpha=1.0, min_samples=1,
                                    hysteresis=0.0, dwell=6), None),
    "battery": ("MCU_EDGE", dict(ewma_alpha=0.5, min_samples=2,
                                 hysteresis=0.01, dwell=1),
                dict(profile="mcu", energy_weight_s_per_j=0.05,
                     battery_j=0.01)),
    "battery_phone": ("PHONE_EDGE", dict(ewma_alpha=0.4, min_samples=2,
                                         hysteresis=0.02, dwell=2),
                      dict(profile="phone", energy_weight_s_per_j=0.2,
                           battery_j=0.3)),
    "outage_heals": ("MCU_EDGE", dict(ewma_alpha=1.0, min_samples=1,
                                      hysteresis=0.0, dwell=1), None),
    "congestion_and_override": ("PHONE_EDGE",
                                dict(ewma_alpha=0.5, min_samples=2,
                                     hysteresis=0.05, dwell=4),
                                dict(profile="phone",
                                     energy_weight_s_per_j=0.1,
                                     battery_j=None)),
}


def _mbps_at(scenario: str, i: int) -> float:
    """The link each scenario's request i sees: healthy, then degraded."""
    if scenario == "outage_heals":
        return 50.0
    return 50.0 if i < 6 else (2.0 if i < 16 else 20.0)


def _pair(config, scenario):
    """Both packages' controllers for one deployment (the compacted
    int8-codec network; the initial split the greedy one at 50 Mbps)."""
    cfg_r, cfg_t, masks = cnn_configs(config)
    edge, knobs, energy = SCENARIOS[scenario]
    n = len(cfg_t.layers)
    cands = tuple(sorted({0, 3, n // 2, n - 1, n}))
    out = []
    for mod, prof, em, cfg in ((rad, rprof, rem, cfg_r),
                               (tad, tprof, tem, cfg_t)):
        profile = prof.TwoTierProfile(getattr(prof, edge), prof.PAPER_SERVER,
                                      prof.LinkProfile("w", 50e6 / 8, 2e-3))
        pol = mod.AdaptivePolicy(candidates=cands, **knobs)
        ep = None
        if energy is not None:
            ep = em.EnergyPolicy(
                profile=em.ENERGY_PROFILES[energy["profile"]],
                energy_weight_s_per_j=energy["energy_weight_s_per_j"],
                battery_j=energy["battery_j"])
        out.append(mod.AdaptiveSplitController.for_deployment(
            cfg, pol, 3, profile, masks=masks, compact=True, codec="int8",
            energy=ep))
    return out


def _state(ctl):
    return (ctl.split, ctl.battery_j, ctl.battery_fraction,
            ctl.effective_energy_weight, ctl.n_requests, ctl._since_switch,
            ctl.estimator.bandwidth, ctl.estimator.n_samples,
            ctl.estimator.ready)


def _drive(ctl, scenario, steps=24):
    """Feed one controller the scenario's events; returns what each
    event returned (the switch or None) and the state after it."""
    log = []
    n = len(ctl.costs)
    for i in range(steps):
        if scenario == "outage_heals" and i == 8:
            log.append((ctl.note_outage(), _state(ctl)))
            continue
        if scenario == "congestion_and_override" and i == 10:
            log.append((ctl.note_congestion(), _state(ctl)))
            continue
        if scenario == "congestion_and_override" and i == 14:
            ctl.note_external_switch(n)
            log.append((None, _state(ctl)))
            continue
        row = ctl.sweep(_mbps_at(scenario, i) * 1e6 / 8)
        cur = next(r for r in row if r["split"] == ctl.split)
        # the request at the current split: its wire bytes over the
        # scenario's link, its joules priced as the runners price them
        tx_bytes = cur["tx_bytes"]
        t_tx = cur["T_TX"] if tx_bytes else 0.0
        if scenario == "outage_heals" and not tx_bytes:
            # over the socket the all-edge split still sends its logits,
            # whose healthy sends pull the estimate back up (heal-back)
            bw, rtt = _mbps_at(scenario, i) * 1e6 / 8, ctl.profile.link.rtt_s
            tx_bytes = 4 * 38 + 40
            t_tx = tx_bytes / bw + rtt
        e = cur.get("E_edge")
        log.append((ctl.step(tx_bytes, t_tx, e), _state(ctl)))
    return log


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("config", ["tiny", "alexnet"])
def test_switch_lists_match_reference(config, scenario):
    r_ctl, t_ctl = _pair(config, scenario)
    want, got = _drive(r_ctl, scenario), _drive(t_ctl, scenario)
    for i, ((sw_r, st_r), (sw_t, st_t)) in enumerate(zip(want, got)):
        assert st_t == st_r, (scenario, i)
        assert (sw_t is None) == (sw_r is None), (scenario, i)
        if sw_r is not None:
            assert dataclasses.asdict(sw_t) == dataclasses.asdict(sw_r)
            assert sw_t.describe() == sw_r.describe()
    assert [dataclasses.asdict(s) for s in t_ctl.history] == \
        [dataclasses.asdict(s) for s in r_ctl.history]
    if scenario == "hysteresis_holds":
        assert not t_ctl.history
    elif scenario == "outage_heals":
        # the outage decision lands on the latest candidate, then the
        # healthy observations pull the split back
        at = next(s for s in t_ctl.history if s.request_index == 8)
        assert at.new_split == len(t_ctl.costs)
        assert t_ctl.split != len(t_ctl.costs)
    else:
        assert t_ctl.history, scenario
    if scenario.startswith("battery"):
        assert t_ctl.battery_j < SCENARIOS[scenario][2]["battery_j"]
        assert all(s.predicted_E is not None and s.battery_j is not None
                   for s in t_ctl.history)


def test_estimator_matches_reference():
    r = rad.BandwidthEstimator(alpha=0.3, min_samples=3, rtt_s=0.002)
    t = tad.BandwidthEstimator(alpha=0.3, min_samples=3, rtt_s=0.002)
    assert t.OUTAGE_BANDWIDTH == r.OUTAGE_BANDWIDTH
    rng = np.random.default_rng(2)
    obs = [(float(b), float(s)) for b, s in
           zip(rng.integers(0, 40000, 12), rng.uniform(0.0, 0.05, 12))]
    obs += [(0, 0.01), (5000, 0.0), (5000, 0.001)]   # ignored / rtt-bound
    for k, (nbytes, secs) in enumerate(obs):
        r.observe(nbytes, secs)
        t.observe(nbytes, secs)
        if k == 6:
            r.note_outage()
            t.note_outage()
        assert (t.bandwidth, t.n_samples, t.ready) == \
            (r.bandwidth, r.n_samples, r.ready)


def test_validation_errors_and_json_match_reference():
    for kw in ({"candidates": ()}, {"candidates": (1,), "ewma_alpha": 0.0},
               {"candidates": (1,), "ewma_alpha": 1.5},
               {"candidates": (1,), "hysteresis": -0.1}):
        with pytest.raises(ValueError) as want:
            rad.AdaptivePolicy(**kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tad.AdaptivePolicy(**kw)
    pol_r = rad.AdaptivePolicy(candidates=(9, 0, 4), ewma_alpha=0.25,
                               min_samples=5, hysteresis=0.2, dwell=7)
    pol_t = tad.AdaptivePolicy.from_json(pol_r.to_json())
    assert pol_t.to_json() == pol_r.to_json()
    assert tad.AdaptivePolicy(candidates=(9, 0, 4), ewma_alpha=0.25,
                              min_samples=5, hysteresis=0.2,
                              dwell=7) == pol_t
    cfg_r, cfg_t, masks = cnn_configs("tiny")
    for mod, prof, cfg in ((rad, rprof, cfg_r), (tad, tprof, cfg_t)):
        with pytest.raises(ValueError, match="not among the candidates"):
            mod.AdaptiveSplitController.for_deployment(
                cfg, mod.AdaptivePolicy(candidates=(0, 3)), 6,
                prof.PAPER_PROFILE, masks=masks, compact=True)


def test_describe_matches_reference():
    kw = dict(request_index=7, old_split=3, new_split=13,
              est_bandwidth=2.5e5, current_T=0.1234, predicted_T=0.0456)
    energy = dict(current_E=0.071, predicted_E=0.052)
    for extra in ({}, energy, {**energy, "battery_j": 0.25}):
        assert tad.SplitSwitch(**kw, **extra).describe() == \
            rad.SplitSwitch(**kw, **extra).describe()


def test_unmetered_controller_and_concurrent_outage():
    """An unmetered controller scores latency only and drains nothing; an
    outage reported from another thread while requests step lands in
    the decision state under the controller's lock (the latest candidate
    wins on a dead link)."""
    _, t_ctl = _pair("tiny", "degrading")
    assert t_ctl._score({"T": 1.0, "E_edge": 99.0}) == 1.0
    t_ctl.drain(5.0)
    assert t_ctl.battery_j is None and t_ctl.battery_fraction is None
    assert t_ctl.effective_energy_weight == 0.0
    n = len(t_ctl.costs)
    done = threading.Event()

    def outage():
        t_ctl.note_outage()
        done.set()
    thread = threading.Thread(target=outage)
    t_ctl.step(6000, 6000 / (50e6 / 8) + 2e-3)
    thread.start()
    thread.join(5)
    assert done.is_set()
    assert t_ctl.split == n and t_ctl.history[-1].new_split == n
    assert t_ctl.estimator.bandwidth == tad.BandwidthEstimator.OUTAGE_BANDWIDTH
