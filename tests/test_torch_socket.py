"""The socket deployment across the two packages: a JAX peer and a torch
peer (on the CPU) serve each other over real TCP on 127.0.0.1.

* ``serve_cloud`` / ``EdgeClient`` of one package against those of the
  other, in both directions, one connection moved through every split by
  RESPLIT after the HELLO digest handshake, for a plain plan and plans
  with a ``quant``, ``batching`` or ``faults`` section (the last with a
  corrupted response the edge recovers from by replay);
* the public entry points: the port's ``connect(plan, "socket")`` against
  the reference's ``serve``/``CloudServer``, and the reverse;
* a digest mismatch raises ``PlanMismatchError`` on the edge of either
  package.

Logits are held to the reference's in-process runner at the same split
with the tolerances of ``test_torch_serving.py``: ``fp32_tol`` for the
fp32 codec; for int8 the gap one codec step at the split can cause
(``cnn_abs_bound``) plus ``fp32_tol``, with equal argmax. At c=N the edge
sends the logits themselves through the codec, so the reference's logits
go through the same codec, and an int8 step of them is the bound. Servers
listen on ports the OS assigns (``torch_parity.free_port``); backoffs
sleep through a no-op, and nothing asserts wall-clock time.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro import serving as rserving
from repro.core.collab import protocol as rproto
from repro.core.collab import runtime as rrt
from repro.core.collab.batching import BatchingPolicy as RBatching
from repro.core.collab.channel import FaultInjector as RInjector
from repro.core.collab.faults import FaultPolicy as RFaults
from repro.core.partition.profiles import FaultEvent as RFaultEvent
from repro.core.partition.profiles import FaultSchedule as RSchedule
from repro_torch import serving as tserving
from repro_torch.core.collab import runtime as trt
from repro_torch.core.collab.batching import BatchingPolicy as TBatching
from repro_torch.core.collab.channel import FaultInjector as TInjector
from repro_torch.core.collab.faults import FaultPolicy as TFaults
from repro_torch.core.collab.protocol import affine_qparams
from repro_torch.core.partition.profiles import FaultEvent as TFaultEvent
from repro_torch.core.partition.profiles import FaultSchedule as TSchedule
from repro_torch.models.cnn import cnn_abs_bound
from torch_parity import (fp32_tol, free_port, port_params, ref_tree,
                          tiny_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

N_LAYERS = len(tiny_setup()[1].layers)     # splits 0..N
# section -> the plan's codec and whether it carries a quant, batching or
# faults section
VARIANTS = {"plain": ("fp32", None), "quant": ("int8", "quant"),
            "batching": ("fp32", "batching"), "faults": ("fp32", "faults")}
#: the data response the faults variant's server corrupts (0-based)
CORRUPTED_RESPONSE = 2


def _plans(split, variant="plain", **transport):
    """The same contract built by both packages; equal digests."""
    cfg_r, cfg_t, params, masks, _ = tiny_setup()
    codec, section = VARIANTS[variant]
    r_extra, t_extra = {}, {}
    if section == "quant":
        r_extra["quant"] = rserving.QuantPolicy(weight_bits=8)
        t_extra["quant"] = tserving.QuantPolicy(weight_bits=8)
    if section == "batching":
        r_extra["batching"] = RBatching(max_batch=4, max_wait_ms=1.0)
        t_extra["batching"] = TBatching(max_batch=4, max_wait_ms=1.0)
    if section == "faults":
        kw = dict(max_retries=3, backoff_base_s=0.001,
                  request_deadline_s=60.0)
        r_extra["faults"], t_extra["faults"] = RFaults(**kw), TFaults(**kw)
    kw = dict(masks=masks, compact=True, codec=codec, shape_link=False,
              **transport)
    p_r = rserving.DeploymentPlan.from_args(ref_tree(params), cfg_r, split,
                                            **kw, **r_extra)
    p_t = tserving.DeploymentPlan.from_args(port_params(params), cfg_t,
                                            split, **kw, **t_extra)
    assert p_t.digest == p_r.digest
    return p_r, p_t


def _images(n, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
            for _ in range(n)]


def _start_server(rt, plan, port, faults=None, **extra):
    """``rt.serve_cloud`` on ``plan`` in a thread, serving until stopped;
    -> (stop event, thread, batch stats, fault stats)."""
    stop, ready = threading.Event(), threading.Event()
    batch_stats, fault_stats = {}, {}
    th = threading.Thread(
        target=rt.serve_cloud,
        args=(plan.params, plan.cfg, plan.split, port),
        kwargs=dict(masks=plan.masks, compact=plan.compact,
                    max_clients=None, stop=stop, ready=ready,
                    plan_digest=plan.digest, batching=plan.batching,
                    batch_stats=batch_stats, fault_policy=plan.faults,
                    faults=faults, fault_stats=fault_stats,
                    quant=plan.quant, **extra),
        daemon=True)
    th.start()
    assert ready.wait(120)
    return stop, th, batch_stats, fault_stats


def _client(rt, plan, port, **extra):
    return rt.EdgeClient(plan.params, plan.cfg, plan.split, port,
                         masks=plan.masks, compact=plan.compact,
                         codec=plan.codec, pack=plan.pack,
                         plan_digest=plan.digest, fault_policy=plan.faults,
                         sleep_fn=lambda s: None, quant=plan.quant,
                         timeout=60.0, **extra)


class _Want:
    """The reference's in-process runner on the same plan: the logits and
    ``tx_bytes`` a split gives, and the bound on a cross-peer gap."""

    def __init__(self, p_r, p_t):
        self.runner = rrt.CollabRunner(
            p_r.params, p_r.cfg, p_r.split, p_r.profile, masks=p_r.masks,
            compact=p_r.compact, codec=p_r.codec, pack=p_r.pack,
            quant=p_r.quant)
        self.bank = trt.SplitFnBank(p_t.params, p_t.cfg, p_t.masks,
                                    p_t.compact, quant=p_t.quant,
                                    device="cpu")
        self.codec = p_r.codec

    def __call__(self, split, image):
        self.runner.set_split(split)
        res = self.runner.infer(image)
        logits = np.asarray(res["logits"])
        if split < N_LAYERS:
            return logits, res["timing"].tx_bytes
        # c=N: the logits are the frame
        buf = rproto.encode_feature(logits, codec=self.codec)
        return np.asarray(rproto.decode_any(buf)[0]), len(buf)

    def bound(self, split, image, logits):
        tol = fp32_tol(logits)
        if self.codec != "int8":
            return tol
        edge = self.bank.get(split)[0]
        with torch.no_grad():
            feat = (edge(torch.from_numpy(image)) if edge is not None
                    else torch.from_numpy(image))
            step, _ = affine_qparams(float(feat.min()), float(feat.max()),
                                     255)
            if split == N_LAYERS:
                return tol + step
            delta = torch.full_like(feat, step)
            return tol + cnn_abs_bound(self.bank._tparams,
                                       self.bank.deploy_cfg, delta,
                                       masks=self.bank._masks,
                                       start_layer=split).numpy()


def _check(want, split, image, got_logits, got_tx):
    lw, tx = want(split, image)
    lg = np.asarray(got_logits)
    assert lg.shape == lw.shape and np.isfinite(lg).all(), split
    assert got_tx == tx, split
    assert (np.abs(lg - lw) <= want.bound(split, image, lw)).all(), split
    if want.codec == "int8":
        assert lg.argmax(-1).tolist() == lw.argmax(-1).tolist(), split


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("edge", ["port", "reference"])
def test_peers_of_the_two_packages_serve_every_split(edge, variant):
    """One connection (re-opened once, in the faults variant, after the
    corrupted response) walks every split by RESPLIT; each request's
    logits and ``tx_bytes`` hold the reference's runner at that split."""
    p_r, p_t = _plans(6, variant)
    want = _Want(p_r, p_t)
    port = free_port()
    srv_rt, srv_plan = (rrt, p_r) if edge == "port" else (trt, p_t)
    cli_rt, cli_plan = (trt, p_t) if edge == "port" else (rrt, p_r)
    srv_extra = {} if edge == "port" else {"device": "cpu"}
    cli_extra = {"device": "cpu"} if edge == "port" else {}
    faults = None
    if variant == "faults":
        inj, ev, sched = ((RInjector, RFaultEvent, RSchedule) if edge == "port"
                          else (TInjector, TFaultEvent, TSchedule))
        faults = inj(sched("corrupt_one",
                           (ev(CORRUPTED_RESPONSE, "corrupt"),)))
    stop, th, batch_stats, fault_stats = _start_server(
        srv_rt, srv_plan, port, faults=faults, **srv_extra)
    client = _client(cli_rt, cli_plan, port, **cli_extra)
    records = []
    try:
        assert client.use_crc      # both peers speak sealed frames
        for split, image in zip(range(N_LAYERS + 1), _images(N_LAYERS + 1)):
            client.resplit(split)
            res = client.infer(image)
            _check(want, split, image, res["logits"], res["tx_bytes"])
            records.append(res["fault"])
    finally:
        client.close()
        stop.set()
        th.join(30)
    n_faults = sum(r["faults"] for r in records)
    n_retries = sum(r["retries"] for r in records)
    if variant == "faults":
        assert (n_faults, n_retries) == (1, 1)
        assert records[CORRUPTED_RESPONSE]["faults"] == 1
        assert fault_stats.get("conn_errors", 0) >= 1
    else:
        assert (n_faults, n_retries) == (0, 0)
    if variant == "batching" and edge == "reference":
        # every request short of c=N went through the port's batcher
        assert sum(s["rows"] for s in batch_stats.values()) == N_LAYERS


@pytest.mark.parametrize("edge", ["port", "reference"])
def test_public_entry_points_serve_each_other(edge):
    """``connect(plan, "socket")`` of one package against
    ``CloudServer(plan)`` of the other, synchronous and pipelined, on the
    int8 quantized plan."""
    p_r, p_t = _plans(6, "quant", port=free_port())
    want = _Want(p_r, p_t)
    images = _images(4, seed=5)
    if edge == "port":
        server = rserving.CloudServer(p_r, max_clients=None)
        session = lambda: tserving.connect(p_t, backend="socket",  # noqa
                                           device="cpu")
    else:
        server = tserving.CloudServer(p_t, max_clients=None, device="cpu")
        session = lambda: rserving.connect(p_r, backend="socket")  # noqa
    with server:
        with session() as sess:
            got = [sess.infer(images[0])] + sess.infer_many(images[1:])
    for image, res in zip(images, got):
        _check(want, 6, image, res["logits"], res["tx_bytes"])
        assert res["fault"] == {"faults": 0, "retries": 0, "migrations": 0,
                                "fallback": False}


@pytest.mark.parametrize("edge", ["port", "reference"])
def test_digest_mismatch_raises_plan_mismatch(edge):
    port = free_port()
    p_r6, p_t6 = _plans(6, port=port)
    p_r3, p_t3 = _plans(3, port=port)
    assert p_t3.digest != p_t6.digest
    if edge == "port":
        with rserving.CloudServer(p_r6, max_clients=None):
            with pytest.raises(tserving.PlanMismatchError):
                tserving.connect(p_t3, backend="socket", device="cpu")
    else:
        with tserving.CloudServer(p_t6, max_clients=None, device="cpu"):
            with pytest.raises(rserving.PlanMismatchError):
                rserving.connect(p_r3, backend="socket")


@pytest.mark.parametrize("section", ["fleet"])
def test_unported_sections_are_refused_by_every_entry_point(section):
    """A plan with a ``fleet`` section, once refused (the test keeps the
    name of that refusal), is served by every entry point: ``connect``
    (``local``, ``socket``, ``streaming``), ``serve``, ``CloudServer``,
    ``CloudFleet``, and a JAX ``CloudServer`` across the digest
    handshake. Every request's logits and ``tx_bytes`` are the bare
    plan's local results, bit for bit: the section changes nothing a peer
    computes."""
    port = free_port()
    p_r, p_t = _plans(6, "quant", port=port)
    sc = tserving.FleetScenario(name="orchard", seed=7, n_edges=1000,
                                n_cloudlets=8, duration_s=30.0)
    kw = dict(masks=p_t.masks, compact=True, codec=p_t.codec,
              quant=p_t.quant, shape_link=False, port=port)
    plan = tserving.DeploymentPlan.from_args(p_t.params, p_t.cfg, 6,
                                             **{section: sc}, **kw)
    assert plan.digest != p_t.digest
    images = _images(3)
    with tserving.connect(p_t, "local", device="cpu") as sess:
        want = sess.infer_many(images)

    def same(got, label):
        assert len(got) == len(want), label
        for g, w in zip(got, want):
            assert np.array_equal(g["logits"], w["logits"]), label
            assert g["tx_bytes"] == w["tx_bytes"], label

    with tserving.connect(plan, "local", device="cpu") as sess:
        same(sess.infer_many(images), "local")
    with tserving.connect(plan, "streaming", device="cpu",
                          realtime_channel=False) as sess:
        same(sess.infer_many(images), "streaming")
    with tserving.CloudServer(plan, device="cpu"):
        with tserving.connect(plan, "socket", device="cpu") as sess:
            same([sess.infer(x) for x in images], "socket")
    ready = threading.Event()
    th = threading.Thread(target=tserving.serve, args=(plan,),
                          kwargs=dict(device="cpu", max_clients=1,
                                      ready=ready), daemon=True)
    th.start()
    assert ready.wait(60)
    with tserving.connect(plan, "socket", device="cpu") as sess:
        same(sess.infer_many(images), "serve")
    th.join(30)
    assert not th.is_alive()
    routed = tserving.DeploymentPlan.from_args(
        p_t.params, p_t.cfg, 6, **{section: sc},
        routing=tserving.RoutingPolicy(ports=(free_port(), free_port())),
        **kw)
    with tserving.CloudFleet(routed, device="cpu"):
        with tserving.connect(routed, "socket", device="cpu") as sess:
            same([sess.infer(x) for x in images], "CloudFleet")
    # a JAX cloud peer on the same fleet plan: equal digests
    r_plan = rserving.DeploymentPlan.from_args(
        p_r.params, p_r.cfg, 6, masks=p_r.masks, compact=True,
        codec=p_r.codec, quant=p_r.quant, shape_link=False, port=port,
        **{section: rserving.FleetScenario.from_json(sc.to_json())})
    assert r_plan.digest == plan.digest
    with rserving.CloudServer(r_plan, max_clients=None):
        with tserving.connect(plan, "socket", device="cpu") as sess:
            got = [sess.infer(x) for x in images]
    for image, res in zip(images, got):
        _check(_Want(p_r, p_t), 6, image, res["logits"], res["tx_bytes"])


@pytest.mark.parametrize("section", ["adaptive", "energy"])
def test_adaptive_and_energy_sections_are_served_by_every_entry_point(
        section):
    """``connect`` (every backend), ``serve`` and ``CloudServer`` serve a
    plan with an ``adaptive`` or ``energy`` section: the socket pair
    answers a request, ``serve`` returns after its one client, and each
    result carries joules exactly when the plan is metered."""
    port = free_port()
    _, p_t = _plans(6, port=port)
    doc = {"adaptive": tserving.AdaptivePolicy(
               candidates=(3, 6, N_LAYERS)).to_json(),
           "energy": tserving.EnergyPolicy(
               profile=tserving.PI_ENERGY,
               energy_weight_s_per_j=0.2).to_json()}[section]
    plan = tserving.DeploymentPlan.from_args(
        p_t.params, p_t.cfg, 6, masks=p_t.masks, compact=True,
        shape_link=False, port=port, **{section: doc})
    image = _images(1)[0]
    metered = section == "energy"
    for backend in ("local", "streaming"):
        with tserving.connect(plan, backend, device="cpu",
                              **({"realtime_channel": False}
                                 if backend == "streaming" else {})) as s:
            res = s.infer(image)
            assert (res["e_edge_j"] is not None) == metered, backend
    with tserving.CloudServer(plan, device="cpu"):
        with tserving.connect(plan, "socket", device="cpu") as sess:
            res = sess.infer(image)
            assert (res["e_edge_j"] is not None) == metered
    ready = threading.Event()
    th = threading.Thread(target=tserving.serve, args=(plan,),
                          kwargs=dict(device="cpu", max_clients=1,
                                      ready=ready), daemon=True)
    th.start()
    assert ready.wait(60)
    with tserving.connect(plan, "socket", device="cpu") as sess:
        assert sess.infer(image)["tx_bytes"] == res["tx_bytes"]
    th.join(30)
    assert not th.is_alive()
