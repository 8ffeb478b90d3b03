"""The port's ``DeploymentPlan`` and split sweep against the reference's:
equal digests and ``describe`` lines, plan directories that load across
the two packages in both directions, identical Eq. 5 sweep rows and
greedy splits, and the energy-aware pick of ``from_args(split=None)``.
Every section is a policy object in both packages (the ``fleet`` section
a ``FleetScenario``); the ``faults`` section is also handed to the port
as the reference's JSON, which the port reads with ``from_json``. The
``unported_sections`` variant keeps its name from when the port held the
``fleet`` section as JSON and refused to serve it."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from repro import serving as rserving
from repro.core.collab.adaptive import AdaptivePolicy
from repro.core.collab.faults import FaultPolicy
from repro.core.fleet.scenario import FleetScenario
from repro_torch.core.fleet.scenario import FleetScenario as TFleetScenario
from repro.core.partition import energy_model as rem
from repro.core.partition import latency_model as rlat
from repro.core.partition import splitter as rsplit
from repro.core.partition.profiles import PAPER_PROFILE as R_PAPER
from repro_torch import serving as tserving
from repro_torch.core.partition import energy_model as tem
from repro_torch.core.partition import latency_model as tlat
from repro_torch.core.partition import splitter as tsplit
from repro_torch.core.partition.profiles import PAPER_PROFILE as T_PAPER
from torch_parity import port_params, ref_tree, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)

VARIANTS = {
    "plain": {},
    "quant": {"quant": "int8"},
    "adaptive": {"adaptive": True},
    "energy": {"energy": True, "adaptive": True},
    "unported_sections": {"fleet": True, "faults": True},
}


def _plans(split, variant, **kw):
    """The same contract built by both packages (the ``faults`` section is
    handed to the port as the reference's ``to_json()``)."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    opts = VARIANTS[variant]
    r_extra, t_extra = {}, {}
    if "quant" in opts:
        r_extra["quant"] = rserving.QuantPolicy(weight_bits=8)
        t_extra["quant"] = tserving.QuantPolicy(weight_bits=8)
    if "adaptive" in opts:
        r_extra["adaptive"] = AdaptivePolicy(candidates=(10, 3, 13),
                                             dwell=4)
        t_extra["adaptive"] = tserving.AdaptivePolicy(candidates=(10, 3, 13),
                                                      dwell=4)
    if "energy" in opts:
        kw_e = dict(energy_weight_s_per_j=0.5, battery_j=7.5)
        r_extra["energy"] = rem.EnergyPolicy(profile=rem.PHONE_ENERGY,
                                             **kw_e)
        t_extra["energy"] = tem.EnergyPolicy(profile=tem.PHONE_ENERGY,
                                             **kw_e)
    if "fleet" in opts:
        kw_f = dict(name="orchard", seed=7, n_edges=40, n_cloudlets=2)
        r_extra["fleet"] = FleetScenario(**kw_f)
        t_extra["fleet"] = TFleetScenario(**kw_f)
    if "faults" in opts:
        pol = FaultPolicy(max_retries=2)
        r_extra["faults"], t_extra["faults"] = pol, pol.to_json()
    p_r = rserving.DeploymentPlan.from_args(
        ref_tree(params), cfg_r, split, masks=masks, **kw, **r_extra)
    p_t = tserving.DeploymentPlan.from_args(
        port_params(params), cfg_t, split, masks=masks, **kw, **t_extra)
    return p_r, p_t


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("split", [6, None])
def test_digest_equals_reference(variant, split):
    for kw in ({"compact": True, "codec": "int8"},
               {"compact": False, "codec": "fp16", "pack": True}):
        p_r, p_t = _plans(split, variant, **kw)
        assert p_t.split == p_r.split
        as_json = lambda doc: json.loads(json.dumps(doc))  # noqa: E731
        assert as_json(p_t.contract()) == as_json(p_r.contract())
        assert p_t.digest == p_r.digest
        assert p_t.describe() == p_r.describe()


def _assert_same_plan(p_t, p_r):
    assert p_t.digest == p_r.digest
    for name, layer in p_r.params.items():
        for leaf, arr in layer.items():
            np.testing.assert_array_equal(p_t.params[name][leaf].numpy(),
                                          np.asarray(arr))
    assert sorted(p_t.masks) == sorted(p_r.masks)
    for i in p_r.masks:
        np.testing.assert_array_equal(p_t.masks[i], p_r.masks[i])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plan_directory_loads_across_packages(variant, tmp_path):
    p_r, p_t = _plans(6, variant, compact=True, codec="int8")
    p_r.save(str(tmp_path / "ref"))
    p_t.save(str(tmp_path / "port"))
    # the two directories hold the same files with the same JSON
    for sub in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / sub)) == [
            "masks.npz", "params.json", "params.npz", "plan.json"]
    for fname in ("plan.json", "params.json"):
        with open(tmp_path / "ref" / fname) as f:
            want = json.load(f)
        with open(tmp_path / "port" / fname) as f:
            assert json.load(f) == want, fname
    loaded = tserving.DeploymentPlan.load(str(tmp_path / "ref"))
    _assert_same_plan(loaded, p_r)
    for name in ("adaptive", "energy", "faults", "fleet"):
        assert getattr(loaded, name) == getattr(p_t, name)  # policy objects
    back = rserving.DeploymentPlan.load(str(tmp_path / "port"))
    _assert_same_plan(p_t, back)
    if p_t.fleet is not None:
        assert isinstance(loaded.fleet, TFleetScenario)
        assert back.fleet == p_r.fleet


@pytest.mark.parametrize("deploy", ["dense", "masked", "packed",
                                    "compacted"])
def test_split_sweep_identical_to_reference(deploy):
    """Same rows (T_D, T_TX, T_S, T, tx_bytes per split) and the same
    greedy split on ``PAPER_PROFILE``: plain Python arithmetic in the
    same order, so equal to the last bit."""
    cfg_r, cfg_t, _, masks, _ = tiny_setup()
    m = None if deploy == "dense" else masks
    compact = deploy == "compacted"
    pack = deploy == "packed"
    if compact:
        c_r = rlat.compacted_cnn_layer_costs(cfg_r, m)
        c_t = tlat.compacted_cnn_layer_costs(cfg_t, m)
    else:
        c_r, c_t = rlat.cnn_layer_costs(cfg_r, m), tlat.cnn_layer_costs(cfg_t, m)
    assert [vars(c) for c in c_t] == [vars(c) for c in c_r]
    for codec in ("fp32", "int8"):
        s_r = lambda c: rlat.wire_tx_scale(cfg_r, m, c, codec=codec,  # noqa
                                           pack=pack, compact=compact)
        s_t = lambda c: tlat.wire_tx_scale(cfg_t, m, c, codec=codec,  # noqa
                                           pack=pack, compact=compact)
        d_r = rsplit.greedy_split(c_r, R_PAPER, rlat.cnn_input_bytes(cfg_r),
                                  tx_scale=s_r)
        d_t = tsplit.greedy_split(c_t, T_PAPER, tlat.cnn_input_bytes(cfg_t),
                                  tx_scale=s_t)
        assert d_t.table == d_r.table
        assert d_t.split_point == d_r.split_point


@pytest.mark.parametrize("energy", ["mcu", "pi", "phone"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "packed"])
def test_energy_section_picks_the_reference_split(compact, energy):
    """``from_args(split=None)`` with an ``energy`` section picks by the
    policy's weighted latency·energy objective: the reference's pick at
    every weight, the greedy split at weight 0."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    edge = {"mcu": "MCU_EDGE", "pi": "PI_EDGE", "phone": "PHONE_EDGE"}
    from repro.core.partition import profiles as rprof
    from repro_torch.core.partition import profiles as tprof
    prof_r = rprof.TwoTierProfile(getattr(rprof, edge[energy]),
                                  rprof.PAPER_SERVER, rprof.PAPER_WIFI)
    prof_t = tprof.TwoTierProfile(getattr(tprof, edge[energy]),
                                  tprof.PAPER_SERVER, tprof.PAPER_WIFI)
    kw = dict(masks=masks, compact=compact, pack=not compact, codec="int8")
    for w in (0.0, 0.1, 1.0, 10.0):
        e_r = rem.EnergyPolicy(profile=rem.ENERGY_PROFILES[energy],
                               energy_weight_s_per_j=w)
        e_t = tem.EnergyPolicy(profile=tem.ENERGY_PROFILES[energy],
                               energy_weight_s_per_j=w)
        p_r = rserving.DeploymentPlan.from_args(
            ref_tree(params), cfg_r, None, profile=prof_r, energy=e_r, **kw)
        p_t = tserving.DeploymentPlan.from_args(
            port_params(params), cfg_t, None, profile=prof_t, energy=e_t,
            **kw)
        assert p_t.split == p_r.split and p_t.digest == p_r.digest
        # the section as JSON picks the same split
        assert tserving.DeploymentPlan.from_args(
            port_params(params), cfg_t, None, profile=prof_t,
            energy=e_t.to_json(), **kw).digest == p_r.digest
        if w == 0.0:
            assert p_t.split == tserving.DeploymentPlan.from_args(
                port_params(params), cfg_t, None, profile=prof_t,
                **kw).split


def test_params_round_trip_exact():
    """Reference tree -> port tensors -> reference tree changes no value,
    dtype or layout."""
    from repro_torch.interop import params_from_reference, params_to_reference
    _, _, params, _, _ = tiny_setup()
    back = params_to_reference(params_from_reference(ref_tree(params)))
    assert sorted(back) == sorted(params)
    for name, layer in params.items():
        for leaf, arr in layer.items():
            assert back[name][leaf].dtype == arr.dtype
            np.testing.assert_array_equal(back[name][leaf], arr)
