"""Kernel-cost calibration of the split model on the CPU: the port's
``KernelCalibration.measure``, ``calibrate_quant_edge`` (the deployed
quantized edge, layer by layer) and ``measure_cnn_layer_times`` (the fp32
layers) give one positive time per layer with each layer run on the output
of the one before, equal to the forward pass; and a sweep over one shared
tuple of layer times equals the reference's. Measured times differ from
run to run and between devices, so nothing here compares two packages'
own measurements or asserts a wall-clock value."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.partition import energy_model as rem
from repro.core.partition import latency_model as rlat
from repro.core.partition import profiles as rprof
from repro.core.partition import splitter as rsplit
from repro_torch.core.collab import quant as tq
from repro_torch.core.collab.runtime import deploy_submodels
from repro_torch.core.partition import energy_model as tem
from repro_torch.core.partition import latency_model as tlat
from repro_torch.core.partition import profiles as tprof
from repro_torch.core.partition import splitter as tsplit
from repro_torch.models.cnn import masks_to
from torch_parity import cnn_configs, port_params, tiny_setup
from torch_parity import one_thread  # noqa: F401 (autouse)


def test_measure_threads_outputs_forward():
    """Each function is called on its predecessor's output (once untimed,
    then ``repeats`` times); the times are positive and one per layer."""
    seen = []

    def layer(k):
        def fn(v):
            seen.append((k, v.clone()))
            return v * 2.0 + k
        return fn
    x0 = torch.arange(6, dtype=torch.float32)
    cal = tlat.KernelCalibration.measure([layer(k) for k in range(4)], x0,
                                         repeats=3)
    assert len(cal.layer_s) == 4 and all(t > 0 for t in cal.layer_s)
    assert [k for k, _ in seen] == [k for k in range(4) for _ in range(4)]
    want = x0
    for k, v in seen[::4]:
        torch.testing.assert_close(v, want, rtol=0, atol=0)
        want = want * 2.0 + k
    assert cal.total_s() == pytest.approx(sum(cal.layer_s))
    assert cal.total_s(2) == pytest.approx(sum(cal.layer_s[:2]))
    assert cal.total_s(0) == 0.0


@pytest.mark.parametrize("bits", [8, None], ids=["int8", "fp32"])
@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "masked"])
def test_calibrate_quant_edge_layers_chain_to_the_forward(compact, bits,
                                                          monkeypatch):
    """Every layer of the deployed bank runs alone through
    ``quant_cnn_apply(start_layer=i, stop_layer=i + 1)`` on the previous
    layer's output; the chain's last output is the full forward's, bit for
    bit."""
    _, cfg, params, masks, x = tiny_setup(batch=1)
    dparams, dcfg, dmasks = deploy_submodels(port_params(params), cfg,
                                             masks, compact)
    qp = tq.quantize_params(dparams, dcfg, tq.QuantPolicy(weight_bits=bits))
    calls = []
    real = tq.quant_cnn_apply

    def spy(qparams, cfg_, v, masks=None, start_layer=0, stop_layer=None,
            backend="ref"):
        out = real(qparams, cfg_, v, masks=masks, start_layer=start_layer,
                   stop_layer=stop_layer, backend=backend)
        calls.append((start_layer, stop_layer, backend, v.clone(),
                      out.clone()))
        return out
    monkeypatch.setattr(tq, "quant_cnn_apply", spy)
    cal = tq.calibrate_quant_edge(qp, dcfg, x, masks=dmasks, repeats=2,
                                  device="cpu")
    n = len(dcfg.layers)
    assert len(cal.layer_s) == n and all(t > 0 for t in cal.layer_s)
    assert [(s, e) for s, e, *_ in calls] == \
        [(i, i + 1) for i in range(n) for _ in range(3)]
    assert {b for _, _, b, _, _ in calls} == {"ref"}
    first = calls[::3]
    torch.testing.assert_close(first[0][3], torch.from_numpy(x), rtol=0,
                               atol=0)
    for prev, cur in zip(first, first[1:]):
        torch.testing.assert_close(cur[3], prev[4], rtol=0, atol=0)
    with torch.inference_mode():
        whole = real(qp, dcfg, torch.from_numpy(x),
                     masks=masks_to(dmasks, torch.device("cpu")))
    torch.testing.assert_close(first[-1][4], whole, rtol=0, atol=0)


def test_measure_cnn_layer_times_on_the_cpu():
    _, cfg, params, masks, x = tiny_setup(batch=1)
    for m in (None, masks):
        times = tlat.measure_cnn_layer_times(port_params(params), cfg, x,
                                             masks=m, repeats=2,
                                             device="cpu")
        assert len(times) == len(cfg.layers)
        assert all(isinstance(t, float) and t > 0 for t in times)
    # numpy parameters and a tensor input take the same path
    assert len(tlat.measure_cnn_layer_times(params, cfg, torch.from_numpy(x),
                                            repeats=1, device="cpu")) == \
        len(cfg.layers)


@pytest.mark.parametrize("config", ["tiny", "alexnet"])
def test_sweep_over_shared_layer_times_matches_reference(config):
    """A calibration's ``layer_s`` into both packages' sweeps: the same
    rows and the same pick, for the latency and the energy objective."""
    cfg_r, cfg_t, masks = cnn_configs(config)
    costs_r = rlat.quantized_cnn_layer_costs(cfg_r, masks, 8)
    costs_t = tlat.quantized_cnn_layer_costs(cfg_t, masks, 8)
    n = len(costs_t)
    layer_s = tuple(float(v) for v in
                    np.random.default_rng(9).uniform(2e-5, 4e-4, n))
    cal = tlat.KernelCalibration(layer_s)
    inp = tlat.cnn_input_bytes(cfg_t)
    kw_r = dict(measured_device_s=layer_s, tx_scale=lambda c:
                rlat.wire_tx_scale(cfg_r, masks, c, codec="int8",
                                   compact=True))
    kw_t = dict(measured_device_s=cal.layer_s, tx_scale=lambda c:
                tlat.wire_tx_scale(cfg_t, masks, c, codec="int8",
                                   compact=True))
    want = rsplit.sweep_splits(costs_r, rprof.PAPER_PROFILE, inp, **kw_r)
    got = tsplit.sweep_splits(costs_t, tprof.PAPER_PROFILE, inp, **kw_t)
    assert got == want and len(got) == n + 1
    assert [r["T_D"] for r in got] == [cal.total_s(c) for c in range(n + 1)]
    assert tsplit.greedy_split(costs_t, tprof.PAPER_PROFILE, inp,
                               **kw_t).split_point == \
        rsplit.greedy_split(costs_r, rprof.PAPER_PROFILE, inp,
                            **kw_r).split_point
    phone_r = rprof.TwoTierProfile(rprof.PHONE_EDGE, rprof.PAPER_SERVER,
                                   rprof.PAPER_WIFI)
    phone_t = tprof.TwoTierProfile(tprof.PHONE_EDGE, tprof.PAPER_SERVER,
                                   tprof.PAPER_WIFI)
    for w in (0.0, 0.3, 3.0):
        pr = rem.EnergyPolicy(profile=rem.PHONE_ENERGY,
                              energy_weight_s_per_j=w)
        pt = tem.EnergyPolicy(profile=tem.PHONE_ENERGY,
                              energy_weight_s_per_j=w)
        want = rsplit.energy_aware_split(costs_r, phone_r, inp, pr, **kw_r)
        got = tsplit.energy_aware_split(costs_t, phone_t, inp, pt, **kw_t)
        assert got.split_point == want.split_point
        assert got.table == want.table
        assert tsplit.pareto_front(got.table) == \
            rsplit.pareto_front(want.table)
