"""The port's fleet simulator (``repro_torch.core.fleet``): every case of
``tests/test_fleet.py`` on the port, then parity with the reference. Both
packages run one scenario and their rollups are compared key by key with
``==``: plain Python arithmetic in the same order and the same seeded
``random.Random`` streams give the same bits, so no tolerance is stated.
Populations are compared draw for draw, scenario JSON byte for byte."""
import json
import os
import random

import numpy as np
import pytest

from repro.core import fleet as rfleet
from repro.core.collab.faults import FaultPolicy as RFaultPolicy
from repro.core.partition import latency_model as rlat
from repro_torch.core import fleet as tfleet
from repro_torch.core.collab.batching import BatchingPolicy
from repro_torch.core.collab.faults import FaultPolicy
from repro_torch.core.fleet import (DEFAULT_SLO_CLASSES, ArrivalPattern,
                                    ChaosEvent, EventQueue, FleetScenario,
                                    FleetSimulator, SLOClass, TierServer,
                                    build_population, percentile,
                                    simulate_fleet)
from repro_torch.core.fleet.population import DEVICE_CLASSES
from repro_torch.core.fleet.tiers import CLOUDLET_SERVER
from repro_torch.core.partition import latency_model as tlat
from repro_torch.core.partition.energy_model import (ENERGY_PROFILES,
                                                     PHONE_ENERGY,
                                                     urgency_scaled_weight)
from repro_torch.core.partition.latency_model import (LayerCost,
                                                      batched_segment_time,
                                                      batched_server_time)
from repro_torch.core.partition.profiles import PHONE_EDGE, PI_EDGE
from torch_parity import cnn_configs
from torch_parity import one_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fleet


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------
def test_event_queue_fires_in_time_then_insertion_order():
    q = EventQueue()
    fired = []
    q.push(2.0, lambda: fired.append("late"))
    q.push(1.0, lambda: fired.append("early"))
    q.push(1.0, lambda: fired.append("early2"))   # same t: insertion order
    n = q.run_until()
    assert n == 3
    assert fired == ["early", "early2", "late"]
    assert q.now == 2.0


def test_event_queue_clamps_past_times_and_nests():
    q = EventQueue()
    fired = []

    def first():
        fired.append(q.now)
        q.push(q.now - 5.0, lambda: fired.append(q.now))  # clamped to now

    q.push(1.0, first)
    q.run_until()
    assert fired == [1.0, 1.0]                    # never moves backwards


def test_event_queue_horizon_stops_early():
    q = EventQueue()
    fired = []
    q.push(1.0, lambda: fired.append(1))
    q.push(5.0, lambda: fired.append(5))
    q.run_until(horizon=2.0)
    assert fired == [1] and len(q) == 1


# ---------------------------------------------------------------------------
# profiles and the shared formulas
# ---------------------------------------------------------------------------
def test_phone_class_sits_between_pi_and_server():
    assert PI_EDGE.flops_per_s < PHONE_EDGE.flops_per_s
    assert PHONE_EDGE.flops_per_s < CLOUDLET_SERVER.flops_per_s
    assert ENERGY_PROFILES["phone"] is PHONE_ENERGY
    assert PHONE_ENERGY.compute_power_w > 0
    assert PHONE_ENERGY.radio.tx_power_w > PHONE_ENERGY.radio.idle_power_w


def test_urgency_scaled_weight_shared_formula():
    w = 0.02
    assert urgency_scaled_weight(w, None) == w
    assert urgency_scaled_weight(w, 1.0) == pytest.approx(w)
    assert urgency_scaled_weight(w, 0.5) == pytest.approx(w * 4)
    assert urgency_scaled_weight(w, 0.0) == pytest.approx(w / 1e-6)


def test_batched_segment_time_generalizes_batched_server_time():
    costs = [LayerCost(i, f"l{i}", 1e9, 1e5) for i in range(5)]
    assert batched_segment_time(costs, 2, 5, CLOUDLET_SERVER, 4) \
        == pytest.approx(batched_server_time(costs, 2, CLOUDLET_SERVER, 4))
    with pytest.raises(ValueError):
        batched_segment_time(costs, 3, 2, CLOUDLET_SERVER, 1)
    with pytest.raises(ValueError):
        batched_segment_time(costs, 0, 5, CLOUDLET_SERVER, 0)


# ---------------------------------------------------------------------------
# scenario + plan section
# ---------------------------------------------------------------------------
def test_scenario_roundtrips_through_json():
    sc = FleetScenario(name="rt", seed=11, n_edges=50, n_cloudlets=3,
                       duration_s=12.0)
    assert FleetScenario.from_json(sc.to_json()) == sc


def test_scenario_validates_mixes_and_batteries():
    with pytest.raises(ValueError, match="shares sum"):
        FleetScenario(name="bad", device_mix=(("mcu", 0.5), ("pi", 0.2)))
    with pytest.raises(ValueError, match="unknown device class"):
        FleetScenario(name="bad", device_mix=(("gpu", 1.0),),
                      battery_j=(("gpu", 10.0),))
    with pytest.raises(ValueError, match="battery_j"):
        FleetScenario(name="bad", battery_j=(("mcu", 0.0),))
    with pytest.raises(ValueError, match="share"):
        SLOClass("x", 0.0, FaultPolicy())


def test_plan_fleet_section_folds_into_digest_only_when_set(tmp_path):
    from repro_torch import serving
    from repro_torch.models.cnn import init_cnn_params, tiny_cnn_config
    cfg = tiny_cnn_config(num_classes=5, hw=32)
    params = init_cnn_params(0, cfg)
    bare = serving.DeploymentPlan.from_args(params, cfg, 3)
    sc = FleetScenario(name="study", seed=5, n_edges=100)
    fleet = serving.DeploymentPlan.from_args(params, cfg, 3, fleet=sc)
    assert bare.digest != fleet.digest          # section is contract-level
    assert "fleet" not in bare.contract()       # only-when-set precedent
    assert fleet.contract()["fleet"] == sc.to_json()
    path = fleet.save(str(tmp_path / "deploy"))
    reloaded = serving.DeploymentPlan.load(path)
    assert reloaded.fleet == sc
    assert reloaded.digest == fleet.digest
    assert "fleet=study" in fleet.describe()


# ---------------------------------------------------------------------------
# population
# ---------------------------------------------------------------------------
def test_population_is_seed_deterministic_and_heterogeneous():
    sc = FleetScenario(name="pop", seed=4, n_edges=400)
    a, b = build_population(sc), build_population(sc)
    assert [(e.device_class, e.trace.name, e.slo.name, e.trace_phase,
             e.cloudlet_id) for e in a] \
        == [(e.device_class, e.trace.name, e.slo.name, e.trace_phase,
             e.cloudlet_id) for e in b]
    classes = {e.device_class for e in a}
    assert classes == set(DEVICE_CLASSES)       # all three classes present
    assert len({e.trace.name for e in a}) > 1
    mcu = sum(1 for e in a if e.device_class == "mcu") / len(a)
    assert 0.15 < mcu < 0.35
    for e in a:
        assert e.battery_left_j == sc.battery_for(e.device_class)


def test_arrivals_are_seeded_and_diurnal():
    sc = FleetScenario(name="arr", seed=9, n_edges=1)
    edge = build_population(sc)[0]
    ts, t = [], 0.0
    for _ in range(200):
        t = edge.next_arrival(t, sc.arrival)
        ts.append(t)
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    edge2 = build_population(sc)[0]
    t2 = [edge2.next_arrival(0.0, sc.arrival)]
    for _ in range(199):
        t2.append(edge2.next_arrival(t2[-1], sc.arrival))
    assert ts == t2                             # same seed, same stream
    rate = len(ts) / ts[-1]
    assert (sc.arrival.base_rate_hz * 0.5 < rate
            < sc.arrival.peak_rate_hz * 1.5)


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------
def _costs(n=6):
    return [LayerCost(i, f"l{i}", 2e9, 1e5) for i in range(n)]


def test_tier_server_fuses_concurrent_arrivals_into_one_batch():
    q = EventQueue()
    srv = TierServer("t", CLOUDLET_SERVER,
                     BatchingPolicy(max_batch=8, max_wait_ms=5.0),
                     _costs(), q)
    done = []
    for i in range(3):
        assert srv.submit((2, 6), i, lambda p, t: done.append((p, t)))
    q.run_until()
    assert [p for p, _ in done] == [0, 1, 2]
    assert srv.stats.batches == 1 and srv.stats.rows == 3
    assert srv.stats.padded_rows == 1
    t_done = {t for _, t in done}
    assert len(t_done) == 1
    t_serve = batched_segment_time(_costs(), 2, 6, CLOUDLET_SERVER, 4)
    assert t_done.pop() == pytest.approx(5e-3 + t_serve)


def test_tier_server_sheds_at_queue_bound():
    q = EventQueue()
    srv = TierServer("t", CLOUDLET_SERVER,
                     BatchingPolicy(max_batch=2, max_wait_ms=1.0),
                     _costs(), q, max_queue=2)
    assert srv.submit((0, 6), "a", lambda p, t: None)
    assert srv.submit((0, 6), "b", lambda p, t: None)
    assert not srv.submit((0, 6), "c", lambda p, t: None)
    assert srv.stats.shed == 1


def test_tier_server_separates_lanes_by_segment():
    q = EventQueue()
    srv = TierServer("t", CLOUDLET_SERVER,
                     BatchingPolicy(max_batch=8, max_wait_ms=1.0),
                     _costs(), q)
    done = []
    srv.submit((1, 6), "seg16", lambda p, t: done.append(p))
    srv.submit((3, 6), "seg36", lambda p, t: done.append(p))
    q.run_until()
    assert sorted(done) == ["seg16", "seg36"]
    assert srv.stats.batches == 2               # different shapes never fuse


# ---------------------------------------------------------------------------
# end-to-end + determinism
# ---------------------------------------------------------------------------
def test_fleet_run_conserves_arrivals_and_uses_every_route():
    sc = FleetScenario(name="e2e", seed=3, n_edges=300, n_cloudlets=2,
                       duration_s=20.0)
    r = simulate_fleet(sc)
    assert r["arrivals"] == r["served"] + r["shed"]
    assert r["served_collab"] > 0 and r["served_edge_only"] > 0
    assert 0.0 < r["deadline_met_frac"] <= 1.0
    assert r["latency_p50_s"] <= r["latency_p99_s"]
    assert r["edge_joules_per_request"] > 0
    assert r["cloudlet_rows"] > 0
    assert r["uplink_mb_total"] > 0


def test_fleet_same_seed_rollups_are_bit_identical():
    sc = FleetScenario(name="det", seed=21, n_edges=250, n_cloudlets=3,
                       duration_s=15.0)
    assert simulate_fleet(sc) == simulate_fleet(sc)


def test_fleet_seed_actually_matters():
    a = simulate_fleet(FleetScenario(name="s", seed=1, n_edges=200,
                                     duration_s=10.0))
    b = simulate_fleet(FleetScenario(name="s", seed=2, n_edges=200,
                                     duration_s=10.0))
    assert a != b


def test_battery_exhaustion_sheds_and_degrades():
    sc = FleetScenario(name="drain", seed=6, n_edges=100, n_cloudlets=2,
                       duration_s=30.0,
                       battery_j=(("mcu", 0.5), ("pi", 0.5),
                                  ("phone", 0.5)))
    sim = FleetSimulator(sc)
    r = sim.run()
    assert r["exhausted_edges"] > 0
    assert r["shed_battery_frac"] > 0
    for e in sim.edges:
        assert e.battery_left_j >= 0.0


def test_strict_slo_sheds_more_than_lenient():
    strict = (SLOClass("tight", 1.0,
                       FaultPolicy(request_deadline_s=0.03,
                                   fallback="fail")),)
    lenient = (SLOClass("loose", 1.0,
                        FaultPolicy(request_deadline_s=30.0,
                                    fallback="edge")),)
    base = dict(seed=5, n_edges=150, n_cloudlets=2, duration_s=10.0)
    r_strict = simulate_fleet(FleetScenario(name="st",
                                            slo_classes=strict, **base))
    r_lenient = simulate_fleet(FleetScenario(name="le",
                                             slo_classes=lenient, **base))
    assert r_strict["shed_frac"] > r_lenient["shed_frac"]
    assert r_lenient["deadline_met_frac"] >= r_strict["deadline_met_frac"]


def test_percentile_pure_python():
    assert percentile([], 99) == 0.0
    assert percentile([5.0], 50) == 5.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
    assert percentile([1.0, 2.0, 3.0, 4.0], 100) == 4.0
    xs = [random.Random(0).random() for _ in range(100)]
    assert min(xs) <= percentile(xs, 1) <= percentile(xs, 99) <= max(xs)


def test_chaos_event_roundtrip_validation_and_scenario_fold():
    """``tests/test_failover.py``'s chaos-event case on the port."""
    ev = ChaosEvent(t_s=5.0, kind="kill", cloudlet=1)
    assert ChaosEvent.from_json(ev.to_json()) == ev
    with pytest.raises(ValueError, match="kind"):
        ChaosEvent(t_s=1.0, kind="meteor")
    with pytest.raises(ValueError, match="t_s"):
        ChaosEvent(t_s=-1.0, kind="kill")
    calm = FleetScenario(name="calm", seed=3, n_edges=50)
    assert "chaos" not in calm.to_json()     # pre-chaos digests unchanged
    stormy = FleetScenario(name="storm", seed=3, n_edges=50,
                           chaos=(ev, ChaosEvent(t_s=9.0, kind="revive",
                                                 cloudlet=1)))
    assert FleetScenario.from_json(stormy.to_json()).chaos == stormy.chaos
    with pytest.raises(ValueError, match="ChaosEvent"):
        FleetScenario(name="bad", chaos=({"t_s": 1.0},))


def test_fleet_sim_chaos_reroutes_deterministically():
    """``tests/test_failover.py``'s chaos case on the port."""
    base = dict(seed=17, n_edges=150, n_cloudlets=3, duration_s=20.0)
    calm = simulate_fleet(FleetScenario(name="calm", **base))
    assert calm["chaos_reroutes_count"] == 0
    sc = FleetScenario(name="storm", chaos=CHAOS, **base)
    r = simulate_fleet(sc)
    assert r["chaos_reroutes_count"] > 0
    assert r == simulate_fleet(sc)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
#: kill cloudlet 0, drain 1, revive 0 (``tests/test_failover.py``'s storm)
CHAOS = (ChaosEvent(t_s=5.0, kind="kill", cloudlet=0),
         ChaosEvent(t_s=8.0, kind="drain", cloudlet=1),
         ChaosEvent(t_s=14.0, kind="revive", cloudlet=0))


def _strict(pkg_fault_policy, pkg_slo):
    """``benchmarks/fleet_sim.py``'s strict mix, in either package."""
    return (pkg_slo("interactive", 0.50,
                    pkg_fault_policy(request_deadline_s=0.15,
                                     fallback="edge", max_retries=0)),
            pkg_slo("standard", 0.50,
                    pkg_fault_policy(request_deadline_s=0.5,
                                     fallback="edge")))


def _scenario_kw(case: str) -> dict:
    """The port's keyword arguments of one parity case; the reference's
    come from its JSON (``_pair``)."""
    if case == "default":           # fleet_sim.py's fast headline cell
        return dict(seed=7, n_edges=1000, n_cloudlets=8, duration_s=30.0)
    if case == "strict":            # its second fast cell
        return dict(seed=7, n_edges=1000, n_cloudlets=2, duration_s=30.0,
                    slo_classes=_strict(FaultPolicy, SLOClass))
    if case == "battery":           # MCU batteries that run out
        return dict(seed=6, n_edges=200, n_cloudlets=2, duration_s=30.0,
                    battery_j=(("mcu", 0.5), ("pi", 250.0),
                               ("phone", 120.0)))
    if case == "chaos":
        return dict(seed=17, n_edges=150, n_cloudlets=3, duration_s=20.0,
                    chaos=CHAOS + (ChaosEvent(t_s=16.0, kind="drain",
                                              cloudlet=2),
                                   ChaosEvent(t_s=17.0, kind="kill",
                                              cloudlet=0)))
    raise KeyError(case)


def _pair(case: str):
    sc = FleetScenario(name=case, **_scenario_kw(case))
    return rfleet.FleetScenario.from_json(sc.to_json()), sc


def _assert_same_rollup(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("case", ["default", "strict", "battery", "chaos"])
def test_rollup_equals_reference(case):
    r_sc, t_sc = _pair(case)
    assert json.dumps(t_sc.to_json(), sort_keys=True) == \
        json.dumps(r_sc.to_json(), sort_keys=True)
    r_sim, t_sim = rfleet.FleetSimulator(r_sc), FleetSimulator(t_sc)
    want, got = r_sim.run(), t_sim.run()
    _assert_same_rollup(got, want)
    assert got["arrivals"] == got["served"] + got["shed"]
    # the run's end state, edge by edge and tier by tier
    assert [e.battery_left_j for e in t_sim.edges] == \
        [e.battery_left_j for e in r_sim.edges]
    assert [vars(c.stats) for c in t_sim.cloudlets] == \
        [vars(c.stats) for c in r_sim.cloudlets]
    assert vars(t_sim.cloud.stats) == vars(r_sim.cloud.stats)
    assert t_sim.events.now == r_sim.events.now
    if case == "battery":
        assert got["exhausted_edges"] > 0 and got["shed_battery_frac"] > 0
        assert {e.device_class for e in t_sim.edges if e.exhausted} == \
            {"mcu"}
    if case == "chaos":
        assert got["chaos_reroutes_count"] > 0
    if case == "strict":
        assert got["shed_frac"] > 0


@pytest.mark.parametrize("size", ["tiny", "alexnet"])
def test_custom_costs_equal_reference(size):
    """``FleetSimulator(sc, costs=..., input_bytes=...)`` over each
    package's ``quantized_cnn_layer_costs`` on shared masks."""
    cfg_r, cfg_t, masks = cnn_configs(size)
    c_r = rlat.quantized_cnn_layer_costs(cfg_r, masks, 8)
    c_t = tlat.quantized_cnn_layer_costs(cfg_t, masks, 8)
    assert [vars(c) for c in c_t] == [vars(c) for c in c_r]
    r_sc, t_sc = _pair("battery")
    want = rfleet.FleetSimulator(
        r_sc, costs=c_r, input_bytes=rlat.cnn_input_bytes(cfg_r)).run()
    got = FleetSimulator(t_sc, costs=c_t,
                         input_bytes=tlat.cnn_input_bytes(cfg_t)).run()
    _assert_same_rollup(got, want)
    with pytest.raises(ValueError, match="input_bytes"):
        FleetSimulator(t_sc, costs=c_t)


def test_default_cost_table_is_alexnet_38():
    from repro_torch.models.cnn import alexnet_config
    sim = FleetSimulator(FleetScenario(name="c", n_edges=1))
    cfg = alexnet_config(38)
    assert [vars(c) for c in sim.costs] == \
        [vars(c) for c in tlat.cnn_layer_costs(cfg)]
    assert sim.input_bytes == tlat.cnn_input_bytes(cfg)
    r_sim = rfleet.FleetSimulator(rfleet.FleetScenario(name="c", n_edges=1))
    assert [vars(c) for c in sim.costs] == [vars(c) for c in r_sim.costs]
    assert sim.input_bytes == r_sim.input_bytes


@pytest.mark.parametrize("seed", [0, 4, 123456789])
def test_population_equals_reference_draw_for_draw(seed):
    sc = FleetScenario(name="pop", seed=seed, n_edges=300, n_cloudlets=7)
    r_sc = rfleet.FleetScenario.from_json(sc.to_json())
    got, want = build_population(sc), rfleet.build_population(r_sc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.eid, g.device_class, g.trace.name, g.trace_phase,
                g.slo.name, g.battery_j, g.battery_left_j, g.cloudlet_id) \
            == (w.eid, w.device_class, w.trace.name, w.trace_phase,
                w.slo.name, w.battery_j, w.battery_left_j, w.cloudlet_id)
        assert g.compute.name == w.compute.name
        assert g.energy.name == w.energy.name
        assert g.rng.getstate() == w.rng.getstate()
    # the arrival streams and the piecewise uplink charges, draw for draw
    for g, w in zip(got[:40], want[:40]):
        tg = tw = 0.0
        for _ in range(20):
            tg = g.next_arrival(tg, sc.arrival)
            tw = w.next_arrival(tw, r_sc.arrival)
            assert tg == tw
            assert g.link_state(tg) == w.link_state(tw)
            assert g.send(150_000, tg) == w.send(150_000, tw)


def _scenarios_for_json():
    yield FleetScenario(name="defaults")
    yield FleetScenario(name="chaos", seed=3, n_edges=50,
                        chaos=CHAOS)
    yield FleetScenario(
        name="custom", seed=99, n_edges=12345, n_cloudlets=5,
        duration_s=7.25, device_mix=(("phone", 0.7), ("mcu", 0.3)),
        trace_mix=(("lte_handover", 1.0),),
        slo_classes=_strict(FaultPolicy, SLOClass),
        arrival=ArrivalPattern(base_rate_hz=0.3, diurnal_amplitude=0.0,
                               period_s=17.0),
        battery_j=(("mcu", 1.5), ("phone", 9.0)),
        energy_weight_s_per_j=0.0,
        cloudlet_batching=BatchingPolicy(max_batch=4, max_wait_ms=0.5),
        cloud_batching=BatchingPolicy(max_batch=32, max_wait_ms=2.0,
                                      buckets=(1, 8, 32)),
        backhaul_mbps=250.0, backhaul_rtt_ms=0.0, max_queue=3,
        codec="int8")


@pytest.mark.parametrize("i", range(3))
def test_scenario_json_is_the_reference_byte_for_byte(i):
    sc = list(_scenarios_for_json())[i]
    r_sc = rfleet.FleetScenario.from_json(json.loads(json.dumps(
        sc.to_json())))
    for sort in (True, False):
        assert json.dumps(sc.to_json(), sort_keys=sort) == \
            json.dumps(r_sc.to_json(), sort_keys=sort)
    back = FleetScenario.from_json(json.loads(json.dumps(r_sc.to_json())))
    assert back == sc
    assert sc.describe() == r_sc.describe()
    # the strict mix written in either package is the same JSON
    assert [s.to_json() for s in _strict(FaultPolicy, SLOClass)] == \
        [s.to_json() for s in _strict(RFaultPolicy, rfleet.SLOClass)]
    assert [s.to_json() for s in DEFAULT_SLO_CLASSES] == \
        [s.to_json() for s in rfleet.DEFAULT_SLO_CLASSES]


def test_percentile_and_tier_server_equal_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100, 1001):
        xs = rng.standard_normal(n).tolist()
        for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
            assert percentile(xs, q) == rfleet.percentile(xs, q)
    # one submit sequence through both packages' TierServer
    from repro.core.collab.batching import BatchingPolicy as RBatching
    from repro.core.partition.latency_model import LayerCost as RLayerCost
    out = []
    for ns, batching, cost in ((rfleet, RBatching, RLayerCost),
                               (tfleet, BatchingPolicy, LayerCost)):
        q = ns.EventQueue()
        costs = [cost(i, f"l{i}", 2e9 * (i + 1), 1e5 * (6 - i))
                 for i in range(6)]
        srv = ns.TierServer("t", ns.CLOUDLET_SERVER,
                            batching(max_batch=4, max_wait_ms=2.0), costs, q,
                            max_queue=9)
        done, admitted = [], []
        for k in range(24):
            seg = ((k % 3), 6)
            q.push(0.0004 * k, lambda s=seg, k=k: admitted.append(
                srv.submit(s, k, lambda p, t: done.append((p, t)))))
        q.run_until()
        out.append((done, admitted, vars(srv.stats), q.now))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# numbers given as ints: coerced to float, so saved plans load in both
# ---------------------------------------------------------------------------
#: every float field of the four scenario types, given as an int
_INT_BUILT = dict(
    name="ints", seed=4, n_edges=60, n_cloudlets=2, duration_s=30,
    device_mix=(("mcu", 1),), trace_mix=(("wifi_steady", 1),),
    battery_j=(("mcu", 40),), energy_weight_s_per_j=0,
    backhaul_mbps=1000, backhaul_rtt_ms=10)


def _int_built(ns, policy):
    return ns.FleetScenario(
        **_INT_BUILT, chaos=(ns.ChaosEvent(t_s=5, kind="kill"),),
        slo_classes=(ns.SLOClass("all", 1, policy(request_deadline_s=1.0)),),
        arrival=ns.ArrivalPattern(base_rate_hz=1, diurnal_amplitude=0,
                                  period_s=60))


def _tiny_plans(r_fleet, t_fleet):
    from repro import serving as rserving
    from repro_torch import serving as tserving
    from torch_parity import port_params, ref_tree, tiny_setup
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    return (rserving.DeploymentPlan.from_args(
                ref_tree(params), cfg_r, 6, masks=masks, fleet=r_fleet),
            tserving.DeploymentPlan.from_args(
                port_params(params), cfg_t, 6, masks=masks, fleet=t_fleet))


def test_int_built_scenario_saves_as_floats_and_loads_in_both(tmp_path):
    """A scenario built with ints (``duration_s=30``) stores floats, so
    its plan saves ``30.0`` and passes ``load``'s digest check in the
    port and in the reference. The cost that remains: the reference keeps
    the int, so the same int-built scenario has another in-memory digest
    there (its own saved plan fails its own ``load``)."""
    from repro import serving as rserving
    from repro_torch import serving as tserving
    sc = _int_built(tfleet, FaultPolicy)
    assert sc == _float_built_twin(sc)
    for value in (sc.duration_s, sc.energy_weight_s_per_j, sc.backhaul_mbps,
                  sc.backhaul_rtt_ms, sc.chaos[0].t_s, sc.slo_classes[0].share,
                  sc.arrival.base_rate_hz, sc.arrival.diurnal_amplitude,
                  sc.arrival.period_s, sc.device_mix[0][1],
                  sc.trace_mix[0][1], sc.battery_j[0][1]):
        assert type(value) is float
    r_sc = _int_built(rfleet, RFaultPolicy)
    p_r, p_t = _tiny_plans(r_sc, sc)
    path = p_t.save(str(tmp_path / "port"))
    with open(os.path.join(path, "plan.json")) as f:
        assert '"duration_s": 30.0' in f.read()
    loaded = tserving.DeploymentPlan.load(path)
    assert loaded.digest == p_t.digest and loaded.fleet == sc
    back = rserving.DeploymentPlan.load(path)
    assert back.digest == p_t.digest
    assert back.fleet == rfleet.FleetScenario.from_json(sc.to_json())
    # the remaining cost: the reference's int-built digest is its own
    assert p_r.digest != p_t.digest
    with pytest.raises(ValueError, match="digest"):
        rserving.DeploymentPlan.load(p_r.save(str(tmp_path / "ref")))


def _float_built_twin(sc):
    return FleetScenario.from_json(json.loads(json.dumps(sc.to_json())))


@pytest.mark.parametrize("i", range(4))
def test_float_built_digests_still_equal_the_reference(i):
    """Coercing changes nothing a float-built scenario folds in: its
    plan's digest equals the reference's, as before."""
    scs = list(_scenarios_for_json())
    if i == len(scs):
        sc = _float_built_twin(_int_built(tfleet, FaultPolicy))
    else:
        sc = scs[i]
    r_sc = rfleet.FleetScenario.from_json(json.loads(json.dumps(
        sc.to_json())))
    p_r, p_t = _tiny_plans(r_sc, sc)
    assert json.dumps(sc.to_json()) == json.dumps(r_sc.to_json())
    assert p_t.digest == p_r.digest
