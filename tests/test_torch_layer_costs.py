"""The transformer split's costs (``repro_torch.core.partition.
latency_model.transformer_layer_costs``) and the tier-B H100 profiles
against the reference: the per-layer costs equal the reference's field for
field (the same float operations in the same order) for every registry
config at full size, prefill at 2,048 and 4,096 tokens and decode; the
greedy and balanced splits of the port pick the reference's split with
equal latencies under the port's ``h100_two_node`` and
``h100_edge_cloud`` profiles, the reference given the same numbers as its
own ``TwoTierProfile``. Pure arithmetic, so everything compares with
``==``."""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs import registry as rreg
from repro.core.partition import latency_model as rlat
from repro.core.partition import profiles as rprof
from repro.core.partition import splitter as rsplit
from repro_torch.configs import registry as treg
from repro_torch.core.partition import latency_model as tlat
from repro_torch.core.partition import profiles as tprof
from repro_torch.core.partition import splitter as tsplit
from repro_torch.roofline import hw

#: (seq_len, decode)
POINTS = [(2048, False), (4096, False), (4096, True)]
H100_PROFILES = ["h100_two_node", "h100_edge_cloud"]


def _fields(costs):
    return [dataclasses.astuple(c) for c in costs]


@pytest.mark.parametrize("seq,decode", POINTS,
                         ids=["prefill2048", "prefill4096", "decode4096"])
@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_transformer_layer_costs_equal_reference(arch, seq, decode):
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    want = rlat.transformer_layer_costs(rcfg, seq, decode=decode)
    got = tlat.transformer_layer_costs(tcfg, seq, decode=decode)
    assert len(got) == tcfg.num_layers
    assert _fields(got) == _fields(want)
    assert all(c.flops > 0 for c in got)


def _reference_profile(p):
    """The port's ``TwoTierProfile`` as the reference's, number for
    number."""
    def compute(c):
        return rprof.ComputeProfile(c.name, c.flops_per_s, c.mem_bw,
                                    c.overhead_s, c.int8_flops_per_s)
    return rprof.TwoTierProfile(compute(p.device), compute(p.server),
                                rprof.LinkProfile(p.link.name,
                                                  p.link.bandwidth,
                                                  p.link.rtt_s))


@pytest.mark.parametrize("seq,decode", POINTS,
                         ids=["prefill2048", "prefill4096", "decode4096"])
@pytest.mark.parametrize("profile", H100_PROFILES)
@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_splits_match_reference(arch, profile, seq, decode):
    """The split the example prints: the input is the token embeddings
    (S x d_model x 2 bytes)."""
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    tp = tprof.PROFILES[profile]
    rp = _reference_profile(tp)
    S = 1 if decode else seq
    inp = S * tcfg.d_model * 2
    rc = rlat.transformer_layer_costs(rcfg, seq, decode=decode)
    tc = tlat.transformer_layer_costs(tcfg, seq, decode=decode)
    for rfn, tfn in ((rsplit.greedy_split, tsplit.greedy_split),
                     (rsplit.balanced_split, tsplit.balanced_split)):
        want, got = rfn(rc, rp, inp), tfn(tc, tp, inp)
        assert got.split_point == want.split_point
        assert got.latency == want.latency
        assert got.table == want.table


def test_h100_profiles_are_priced_from_the_device_model():
    """Nodes of 8 and a cluster of 256 cards at the data sheet's bf16 and
    HBM rates; the links at the node fabric's and a 200 Gb/s uplink's
    rates; both in ``PROFILES``."""
    two, edge = tprof.PROFILES["h100_two_node"], tprof.PROFILES[
        "h100_edge_cloud"]
    assert two.device == two.server == edge.device == tprof.H100_NODE
    assert (tprof.H100_NODE.flops_per_s, tprof.H100_NODE.mem_bw) == (
        8 * hw.PEAK_FLOPS_BF16, 8 * hw.HBM_BW)
    assert edge.server == tprof.H100_CLUSTER
    assert (tprof.H100_CLUSTER.flops_per_s, tprof.H100_CLUSTER.mem_bw) == (
        256 * hw.PEAK_FLOPS_BF16, 256 * hw.HBM_BW)
    assert two.link.bandwidth == hw.NODE_FABRIC_BW == 8 * 400e9 / 8
    assert edge.link.bandwidth == 200e9 / 8 < two.link.bandwidth
