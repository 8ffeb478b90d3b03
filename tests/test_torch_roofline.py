"""The port's roofline against the reference's: ``quant_edge_roofline``
rows equal to the last bit on the edge classes (plain Python arithmetic in
the same order), ``check_quant_edge_roofline`` raising on the same inputs
with the same message, and ``RooflineTerms`` priced on the H100 device
model. No TPU constant may stay anywhere in ``src/repro_torch/``, and
``chip_smoke.py`` reads the card's peaks from ``roofline.hw``."""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import os

import pytest

from repro.core.partition import profiles as rprof
from repro.roofline import analysis as ran
from repro.roofline import hw as rhw
from repro_torch.core.partition import profiles as tprof
from repro_torch.roofline import analysis as tan
from repro_torch.roofline import hw
from torch_parity import cnn_configs
from torch_parity import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
EDGES = ("MCU_EDGE", "PI_EDGE", "PHONE_EDGE")


def _profiles(name):
    """The edge class of each package; ``H100_CARD`` against the
    reference's ``ComputeProfile`` built from the same fields."""
    t = getattr(tprof, name)
    if name == "H100_CARD":
        return rprof.ComputeProfile(**dataclasses.asdict(t)), t
    return getattr(rprof, name), t


@pytest.mark.parametrize("bits", [8, None], ids=["int8", "fp32"])
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("size", ["tiny", "alexnet"])
def test_rows_equal_reference(size, edge, bits):
    cfg_r, cfg_t, masks = cnn_configs(size)
    p_r, p_t = _profiles(edge)
    assert dataclasses.asdict(p_t) == dataclasses.asdict(p_r)
    want = ran.quant_edge_roofline(cfg_r, masks, p_r, weight_bits=bits)
    got = tan.quant_edge_roofline(cfg_t, masks, p_t, weight_bits=bits)
    assert want and got == want
    # unmasked as well
    assert tan.quant_edge_roofline(cfg_t, None, p_t, bits) == \
        ran.quant_edge_roofline(cfg_r, None, p_r, bits)


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except AssertionError as e:
        return "raised", str(e)


@pytest.mark.parametrize("share", [0.5, 0.99])
@pytest.mark.parametrize("bits", [8, None], ids=["int8", "fp32"])
@pytest.mark.parametrize("edge", EDGES + ("H100_CARD",))
def test_check_raises_on_the_reference_inputs(edge, bits, share):
    """Same verdict and, where it raises, the same message."""
    cfg_r, cfg_t, masks = cnn_configs("alexnet")
    p_r, p_t = _profiles(edge)
    want = _outcome(ran.check_quant_edge_roofline, cfg_r, masks, p_r,
                    weight_bits=bits, min_memory_share=share)
    got = _outcome(tan.check_quant_edge_roofline, cfg_t, masks, p_t,
                   weight_bits=bits, min_memory_share=share)
    assert got == want


def test_edge_verdicts_of_the_reference_tests():
    """The reference's claims on the port: int8 fc layers memory-bound on
    the MCU and Pi classes (``benchmarks/kernel_edge.py``), fp32 ones
    compute-bound on the MCU."""
    _, cfg, masks = cnn_configs("alexnet")
    for edge in (tprof.MCU_EDGE, tprof.PI_EDGE):
        fc = [r for r in tan.check_quant_edge_roofline(cfg, masks, edge)
              if r["name"].startswith("fc")]
        assert fc and all(r["memory_share"] >= 0.5 for r in fc)
    with pytest.raises(AssertionError, match="compute-bound"):
        tan.check_quant_edge_roofline(cfg, masks, tprof.MCU_EDGE,
                                      weight_bits=None)


def test_h100_card_prices_the_q8_kernel_at_the_fp32_rate():
    """``masked_matmul_q8`` dequantizes into fp32 FMAs: the card's int8
    pricing is its fp32 rate, not the int8 tensor cores'."""
    card = tprof.H100_CARD
    assert card.flops_per_s == card.int8_ops_per_s == hw.PEAK_FLOPS_FP32
    assert card.mem_bw == hw.HBM_BW
    _, cfg, masks = cnn_configs("alexnet")
    int8 = tan.quant_edge_roofline(cfg, masks, card, 8)
    fp32 = tan.quant_edge_roofline(cfg, masks, card, None)
    assert [r["t_compute_s"] for r in int8] == \
        [r["t_compute_s"] for r in fp32]
    # fc weights stream 4x fewer bytes from int8 codes (plus scales)
    for a, b in zip(int8, fp32):
        if a["name"].startswith("fc"):
            assert a["t_memory_s"] < b["t_memory_s"]


def test_device_model_is_the_h100_data_sheet():
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_FP32 == 67e12
    assert hw.PEAK_OPS_INT8 == 1979e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80 * 2 ** 30
    assert hw.L2_BYTES == 50 * 2 ** 20
    assert hw.SM_COUNT == 132
    assert hw.NVLINK_BW == 900e9
    assert hw.NVLINK_BW_PER_DIRECTION == 450e9
    for name in ("ICI_BW_PER_LINK", "SINGLE_POD_CHIPS", "MULTI_POD_CHIPS"):
        assert not hasattr(hw, name)


@pytest.mark.parametrize("flops,hbm,coll,chips,dominant", [
    (989e12, 1.0, 0.0, 1, "compute"),          # one second of bf16
    (1.0, 3.35e12, 0.0, 4, "memory"),          # one second of HBM
    (1.0, 1.0, 450e9, 4, "collective"),        # one second one way
    (2e12, 3.35e9, 9e8, 4, "compute"),
])
def test_roofline_terms_on_the_h100(flops, hbm, coll, chips, dominant):
    t = tan.RooflineTerms(flops, hbm, coll, chips)
    assert t.t_compute == flops / 989e12
    assert t.t_memory == hbm / 3.35e12
    assert t.t_collective == coll / 450e9
    assert t.dominant == dominant
    assert t.flops_global == flops * chips
    assert t.hbm_bytes_global == hbm * chips
    r = ran.RooflineTerms(flops, hbm, coll, chips)
    # the reference's keys, with this card's terms
    assert sorted(t.as_dict()) == sorted(r.as_dict())
    d = t.as_dict()
    assert (d["t_compute_s"], d["t_memory_s"], d["t_collective_s"]) == \
        (t.t_compute, t.t_memory, t.t_collective)
    assert d["collective_bytes_per_chip"] == coll and d["chips"] == chips


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(dirpath, f)


#: the reference's TPU v5e numbers (``roofline/hw.py``, the TPU tier of
#: ``profiles.py``): peak, HBM rate and size, ICI and DCN links, pod sizes
V5E_VALUES = {rhw.PEAK_FLOPS_BF16, rhw.HBM_BW, rhw.ICI_BW_PER_LINK,
              float(rhw.HBM_BYTES), 256 * rhw.PEAK_FLOPS_BF16,
              256 * rhw.HBM_BW, 8 * rhw.PEAK_FLOPS_BF16, 8 * rhw.HBM_BW,
              16 * rhw.ICI_BW_PER_LINK, 100e9 / 8}
V5E_NAMES = ("v5e", "V5E", "ICI_BW", "INTER_POD_ICI", "TPU_TWO_POD",
             "TPU_EDGE_CLOUD", "DCN_LINK", "SINGLE_POD_CHIPS",
             "MULTI_POD_CHIPS", "tpu_two_pod", "tpu_edge_cloud")


_OPS = {ast.Mult: lambda x, y: x * y, ast.Div: lambda x, y: x / y,
        ast.Pow: lambda x, y: x ** y if abs(y) < 64 else None}


def _number(node):
    """The value of a numeric literal or of a product, quotient or power
    of numeric literals; None for anything else."""
    if isinstance(node, ast.Constant):
        ok = isinstance(node.value, (int, float)) and \
            not isinstance(node.value, bool)
        return node.value if ok else None
    if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
        x, y = _number(node.left), _number(node.right)
        if x is None or y is None or (isinstance(node.op, ast.Div)
                                      and y == 0):
            return None
        return _OPS[type(node.op)](x, y)
    return None


def test_no_tpu_constant_in_the_port():
    """No v5e value or name anywhere in ``src/repro_torch/``: neither a
    numeric literal equal to one (nor a product of literals, as
    ``16 * 1024 ** 3``) nor one of the TPU tier's names."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, REPO)
        bad += [f"{rel}: {n}" for n in V5E_NAMES if n in text]
        if not path.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(text, filename=path)):
            v = _number(node)
            if v is not None and float(v) in V5E_VALUES:
                bad.append(f"{rel}:{node.lineno} {v!r}")
    assert not bad, bad
    assert hasattr(tprof, "H100_CARD")
    assert set(tprof.PROFILES) == {"paper", "paper_farm", "h100_two_node",
                                   "h100_edge_cloud"}


def test_chip_smoke_reads_its_peaks_from_the_device_model():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.hw is hw
    assert (smoke.PEAK_BYTES_S, smoke.PEAK_FP32_FLOP_S,
            smoke.PEAK_BF16_FLOP_S, smoke.L2_BYTES) == \
        (3.35e12, 67e12, 989e12, 50 * 2 ** 20)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    # assigned from ``hw``, not written out
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") in ("PEAK_BYTES_S", "PEAK_FP32_FLOP_S",
                                         "PEAK_BF16_FLOP_S", "L2_BYTES")
                for t in node.targets):
            assert isinstance(node.value, ast.Attribute), node.lineno
            assert node.value.value.id == "hw"
