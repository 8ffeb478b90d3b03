"""Fleet routing: the port's ``FleetRouter`` against the reference's on one
event sequence (routes, health states, stats), and failover of a port
socket session across a port ``CloudFleet`` on the CPU — a member killed,
a member drained, then the whole fleet gone and the edge-only fallback —
with a no-op backoff sleep."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.collab import cluster as rcl
from repro_torch import serving as tserving
from repro_torch.core.collab import cluster as tcl
from torch_parity import free_port, port_params, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# one event sequence: (op, args); "tick" advances both fake clocks
EVENTS = [("route", ("raw",)), ("route", ("int8",)), ("route", ("fp16",)),
          ("miss", 0), ("route", ("raw",)), ("miss", 0), ("route", ("raw",)),
          ("route", ("raw", (1,))), ("ok", 1), ("drain", 2),
          ("route", ("int8+packed",)), ("tick", 6.0),
          ("route", ("raw",)), ("ok", 0), ("miss", 1), ("miss", 1),
          ("miss", 1), ("revive", 2), ("route", ("fp16",)),
          ("miss", 0), ("miss", 0), ("miss", 2), ("miss", 2),
          ("route", ("raw", (0, 2))), ("ok", 99)]


def _apply(router, clock, ports, op, arg):
    if op == "route":
        key, *excl = arg
        exclude = tuple(ports[i] for i in excl[0]) if excl else ()
        try:
            return router.route(key, exclude=exclude)
        except ConnectionError as e:
            return type(e).__name__
    if op == "tick":
        clock.t += arg
        return None
    port = ports[arg] if arg < len(ports) else arg
    return {"miss": router.note_miss, "ok": router.note_ok,
            "drain": router.note_drain, "revive": router.revive}[op](port)


def test_router_routes_and_state_machine_equal_reference():
    ports = (31001, 31002, 31003)
    kw = dict(ports=ports, suspect_after_count=1, dead_after_count=2,
              retry_dead_s=5.0)
    clocks = (_Clock(), _Clock())
    routers = (rcl.FleetRouter(rcl.RoutingPolicy(**kw), clock=clocks[0]),
               tcl.FleetRouter(tcl.RoutingPolicy(**kw), clock=clocks[1]))
    for op, arg in EVENTS:
        got = [_apply(r, c, ports, op, arg) for r, c in zip(routers, clocks)]
        assert got[1] == got[0], (op, arg)
        assert [routers[1].state(p) for p in ports] == \
            [routers[0].state(p) for p in ports], (op, arg)
        assert routers[1].healthy_ports() == routers[0].healthy_ports()
    assert routers[1].stats() == routers[0].stats()


def test_all_dead_raises_fleet_exhausted_in_both():
    for mod in (rcl, tcl):
        r = mod.FleetRouter(mod.RoutingPolicy(ports=(1, 2)),
                            clock=_Clock())
        for p in (1, 2):
            r.note_miss(p)
            r.note_miss(p)
        with pytest.raises(mod.FleetExhaustedError):
            r.route("raw")


def _images(n):
    rng = np.random.default_rng(4)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


def test_session_fails_over_across_a_port_fleet():
    _, cfg, params, masks, _ = tiny_setup()
    ports = tuple(free_port() for _ in range(3))
    plan = tserving.DeploymentPlan.from_args(
        port_params(params), cfg, 6, masks=masks, compact=True,
        codec="int8", shape_link=False,
        faults=tserving.FaultPolicy(max_retries=4, backoff_base_s=0.001,
                                    request_deadline_s=60.0),
        routing=tserving.RoutingPolicy(ports=ports))
    local = tserving.connect(plan, backend="local", device="cpu")
    full = tserving.connect(
        tserving.DeploymentPlan.from_args(
            port_params(params), cfg, len(cfg.layers), masks=masks,
            compact=True, codec="int8"), backend="local", device="cpu")
    images = _images(5)

    def same(res, want):
        assert np.array_equal(res["logits"], want["logits"])

    with tserving.CloudFleet(plan, device="cpu") as fleet:
        sess = tserving.connect(plan, backend="socket", device="cpu",
                                sleep_fn=lambda s: None)
        try:
            res = sess.infer(images[0])
            same(res, local.infer(images[0]))
            home = sess._client._port
            assert home in ports and res["fault"]["faults"] == 0
            # crash the member serving us: the replay lands elsewhere
            fleet.kill(home)
            res = sess.infer(images[1])
            same(res, local.infer(images[1]))
            assert res["fault"]["faults"] >= 1
            assert not res["fault"]["fallback"]
            second = sess._client._port
            assert second != home
            # rolling restart of the new member: the DRAIN reply migrates
            # the request (the killed member, only suspect after one miss,
            # may still be tried on the way: a fault, not a fallback)
            fleet.drain(second)
            res = sess.infer(images[2])
            same(res, local.infer(images[2]))
            assert res["fault"]["migrations"] == 1
            assert not res["fault"]["fallback"]
            assert sess._client._port not in (home, second)
            # the whole fleet gone: the edge-only fallback's bits are a
            # local c=N run's
            for p in ports:
                fleet.kill(p)
            res = sess.infer(images[3])
            assert res["fault"]["fallback"] and res["tx_bytes"] == 0
            same(res, full.infer(images[3]))
            stats = sess.router.stats()
            assert stats["servers"][home]["state"] == tcl.STATE_DEAD
            assert stats["reroutes_count"] >= 1
        finally:
            sess.close()
