"""The port's energy model and energy-aware split selection against the
reference's: the per-state pricing formula, the canned device profiles and
their JSON, the battery-urgency curve, the priced Eq. 5 sweep (with shared
measured layer times), the weighted-objective pick, the Pareto front, and
the quantized-cost and wire-byte helpers of the latency model.

Everything here is plain Python arithmetic in the same order in both
packages, so tables, picks and fronts are held *equal*, float for float;
the tiny config and full-width AlexNet (only arithmetic runs there) with
masks that keep half of every prunable layer."""
from __future__ import annotations

import re

import numpy as np
import pytest

from repro.core.partition import energy_model as rem
from repro.core.partition import latency_model as rlat
from repro.core.partition import profiles as rprof
from repro.core.partition import splitter as rsplit
from repro_torch.core.partition import energy_model as tem
from repro_torch.core.partition import latency_model as tlat
from repro_torch.core.partition import profiles as tprof
from repro_torch.core.partition import splitter as tsplit
from torch_parity import cnn_configs, port_params, ref_tree, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)

#: (energy profile, the compute profile it pairs with) by name
PAIRS = {"mcu": "MCU_EDGE", "pi": "PI_EDGE", "phone": "PHONE_EDGE",
         "paper_edge": "PAPER_EDGE"}
CONFIGS = ("tiny", "alexnet")


def _profiles(energy, mbps=50.0, rtt_s=1e-3):
    """(ref, port) two-tier profiles: the energy profile's edge class,
    the paper's server, a link of ``mbps``."""
    def build(mod):
        return mod.TwoTierProfile(getattr(mod, PAIRS[energy]),
                                  mod.PAPER_SERVER,
                                  mod.LinkProfile("test", mbps * 1e6 / 8,
                                                  rtt_s))
    return build(rprof), build(tprof)


def _sweep_kw(cfg_r, cfg_t, masks, codec="int8"):
    """(ref, port) keyword sets of one compacted deployment's sweep."""
    return ({"tx_scale": lambda c: rlat.wire_tx_scale(
                cfg_r, masks, c, codec=codec, compact=True)},
            {"tx_scale": lambda c: tlat.wire_tx_scale(
                cfg_t, masks, c, codec=codec, compact=True)})


def _layer_s(n, seed=5):
    """A shared tuple of per-layer seconds (what a calibration hands in)."""
    return tuple(float(v) for v in
                 np.random.default_rng(seed).uniform(1e-5, 3e-3, n))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_canned_profiles_and_breakdown_match_reference(name):
    r, t = rem.ENERGY_PROFILES[name], tem.ENERGY_PROFILES[name]
    assert t.to_json() == r.to_json()
    assert tem.EnergyProfile.from_json(r.to_json()) == t
    rng = np.random.default_rng(7)
    for t_d, t_tx, t_s, rtt in rng.uniform(0.0, 0.2, (6, 4)).tolist() + [
            [0.3, 0.0, 0.0, 0.004], [0.0, 0.002, 0.01, 0.004]]:
        assert t.energy_breakdown(t_d, t_tx, t_s, rtt) == \
            r.energy_breakdown(t_d, t_tx, t_s, rtt)
        assert t.request_energy(t_d, t_tx, t_s, rtt) == \
            r.request_energy(t_d, t_tx, t_s, rtt)


def test_urgency_weight_policy_and_validation_match_reference():
    for frac in (None, 1.0, 0.5, 0.1, 1e-4, 0.0):
        assert tem.urgency_scaled_weight(0.25, frac) == \
            rem.urgency_scaled_weight(0.25, frac)
    kw = dict(latency_weight=0.7, energy_weight_s_per_j=0.3, battery_j=12.5)
    pr = rem.EnergyPolicy(profile=rem.PHONE_ENERGY, **kw)
    pt = tem.EnergyPolicy(profile=tem.PHONE_ENERGY, **kw)
    assert pt.to_json() == pr.to_json()
    assert tem.EnergyPolicy.from_json(pr.to_json()) == pt
    row = {"T": 0.02, "E_edge": 0.07}
    for w in (None, 0.0, 4.0):
        assert pt.score(row, w) == pr.score(row, w)
    bad = ((lambda m: m.RadioProfile("r", tx_power_w=-1.0, rx_power_w=0.1)),
           (lambda m: m.EnergyProfile("d", compute_power_w=-0.1,
                                      idle_power_w=0.0,
                                      radio=m.MCU_ENERGY.radio)),
           (lambda m: m.EnergyPolicy(profile=m.MCU_ENERGY, battery_j=0.0)),
           (lambda m: m.EnergyPolicy(profile=m.MCU_ENERGY,
                                     energy_weight_s_per_j=-1.0)))
    for make in bad:
        with pytest.raises(ValueError) as want:
            make(rem)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            make(tem)


@pytest.mark.parametrize("energy", ["mcu", "phone", "paper_edge"])
@pytest.mark.parametrize("config", CONFIGS)
def test_priced_sweep_tables_match_reference(config, energy):
    """``sweep_splits(energy=..., measured_device_s=..., measured_server_s=
    ...)`` and ``split_energy`` row for row, float for float; the analytic
    and the measured device terms both."""
    cfg_r, cfg_t, masks = cnn_configs(config)
    costs_r = rlat.quantized_cnn_layer_costs(cfg_r, masks, 8)
    costs_t = tlat.quantized_cnn_layer_costs(cfg_t, masks, 8)
    n = len(costs_t)
    prof_r, prof_t = _profiles(energy)
    kw_r, kw_t = _sweep_kw(cfg_r, cfg_t, masks)
    inp = tlat.cnn_input_bytes(cfg_t)
    assert inp == rlat.cnn_input_bytes(cfg_r)
    for measured in ({}, {"measured_device_s": _layer_s(n)},
                     {"measured_device_s": _layer_s(n),
                      "measured_server_s": _layer_s(n, seed=6)}):
        want = rsplit.sweep_splits(costs_r, prof_r, inp,
                                   energy=rem.ENERGY_PROFILES[energy],
                                   **measured, **kw_r)
        got = tsplit.sweep_splits(costs_t, prof_t, inp,
                                  energy=tem.ENERGY_PROFILES[energy],
                                  **measured, **kw_t)
        assert got == want
        assert len(got) == n + 1
        for c in (0, n // 2, n):
            assert tem.split_energy(
                costs_t, c, prof_t, tem.ENERGY_PROFILES[energy], inp,
                tx_scale=kw_t["tx_scale"](c), **measured) == \
                rem.split_energy(costs_r, c, prof_r,
                                 rem.ENERGY_PROFILES[energy], inp,
                                 tx_scale=kw_r["tx_scale"](c), **measured)


@pytest.mark.parametrize("energy", ["mcu", "pi", "phone"])
@pytest.mark.parametrize("config", CONFIGS)
def test_energy_aware_picks_and_pareto_fronts_match_reference(config,
                                                              energy):
    """The weighted-objective pick over several weights and links, its
    table, and the Pareto front (T ascending, E strictly descending) are
    the reference's; at weight 0 the pick is the greedy split."""
    cfg_r, cfg_t, masks = cnn_configs(config)
    costs_r = rlat.compacted_cnn_layer_costs(cfg_r, masks)
    costs_t = tlat.compacted_cnn_layer_costs(cfg_t, masks)
    kw_r, kw_t = _sweep_kw(cfg_r, cfg_t, masks, codec="fp32")
    inp = tlat.cnn_input_bytes(cfg_t)
    picks = set()
    for mbps in (50.0, 5.0, 0.5):
        prof_r, prof_t = _profiles(energy, mbps)
        for w in (0.0, 0.05, 0.5, 5.0):
            pol_r = rem.EnergyPolicy(profile=rem.ENERGY_PROFILES[energy],
                                     energy_weight_s_per_j=w)
            pol_t = tem.EnergyPolicy(profile=tem.ENERGY_PROFILES[energy],
                                     energy_weight_s_per_j=w)
            want = rsplit.energy_aware_split(costs_r, prof_r, inp, pol_r,
                                             **kw_r)
            got = tsplit.energy_aware_split(costs_t, prof_t, inp, pol_t,
                                            **kw_t)
            assert got.split_point == want.split_point
            assert got.table == want.table and got.latency == want.latency
            picks.add(got.split_point)
            if w == 0.0:
                assert got.split_point == tsplit.greedy_split(
                    costs_t, prof_t, inp, **kw_t).split_point
            # an urgency-scaled override of the static weight
            assert tsplit.energy_aware_split(
                costs_t, prof_t, inp, pol_t, energy_weight=2 * w + 1,
                **kw_t).split_point == rsplit.energy_aware_split(
                costs_r, prof_r, inp, pol_r, energy_weight=2 * w + 1,
                **kw_r).split_point
        front = tsplit.pareto_front(got.table)
        assert front == rsplit.pareto_front(want.table)
        ts = [r["T"] for r in front]
        es = [r["E_edge"] for r in front]
        assert ts == sorted(ts)
        assert all(a > b for a, b in zip(es, es[1:]))
        assert front[0]["T"] == min(r["T"] for r in got.table)
        assert front[-1]["E_edge"] == min(r["E_edge"] for r in got.table)
    assert picks, "no split picked"


@pytest.mark.parametrize("config", CONFIGS)
def test_quantized_costs_match_reference(config):
    cfg_r, cfg_t, masks = cnn_configs(config)
    for bits in (8, 4, None):
        for bpe in (4, 2):
            want = rlat.quantized_cnn_layer_costs(cfg_r, masks, bits, bpe)
            got = tlat.quantized_cnn_layer_costs(cfg_t, masks, bits, bpe)
            assert [vars(c) for c in got] == [vars(c) for c in want]
    fp32 = tlat.quantized_cnn_layer_costs(cfg_t, masks, None)
    q8 = tlat.quantized_cnn_layer_costs(cfg_t, masks, 8)
    assert [c.params_bytes / 4 for c in fp32] == \
        [c.params_bytes for c in q8]


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_layer_output_bytes_match_reference(masked):
    """The wire payload per split point from a forward pass with
    intermediates: the surviving units only, per batch row."""
    cfg_r, cfg_t, params, masks, x = tiny_setup(batch=2)
    m = masks if masked else None
    want = rlat.cnn_layer_output_bytes(ref_tree(params), cfg_r, x, masks=m)
    got = tlat.cnn_layer_output_bytes(port_params(params), cfg_t, x,
                                      masks=m)
    assert got == want
    assert tlat.cnn_layer_output_bytes(params, cfg_t, x, masks=m) == want
    assert len(got) == len(cfg_t.layers) and all(b > 0 for b in got)
