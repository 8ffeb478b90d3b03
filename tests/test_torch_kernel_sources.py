"""Each CUDA kernel's wrapper and its C entry points agree: every entry a
wrapper loads is defined in its ``csrc/<name>.cu`` as ``extern "C"``, with
one parameter per ctypes argument type the wrapper declares plus the
stream (``build.launch`` appends it). The sources are compiled only on a
machine with a card; this holds the binding on the CPU."""
from __future__ import annotations

import importlib
import re

import pytest

from repro_torch.kernels import build

WRAPPERS = {"masked_matmul": "repro_torch.kernels.masked_matmul.ops",
            "rmsnorm": "repro_torch.kernels.rmsnorm.ops",
            "flash_attention": "repro_torch.kernels.flash_attention.ops",
            "ssd_scan": "repro_torch.kernels.ssd_scan.ops"}


def _c_entries(name):
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


def test_every_kernel_is_built():
    assert sorted(build.KERNELS) == sorted(WRAPPERS)
    for name in build.KERNELS:
        assert (build.CSRC_DIR / f"{name}.cu").is_file()


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_entries_match_the_c_signatures(name):
    ops = importlib.import_module(WRAPPERS[name])
    entries = _c_entries(name)
    assert set(ops._ENTRIES.values()) == set(entries)
    for symbol, params in entries.items():
        assert len(params) == len(ops._ARGTYPES) + 1, symbol
        assert params[-1].startswith("cudaStream_t")
        for p, argtype in zip(params, ops._ARGTYPES):
            kind = argtype.__name__
            if kind == "c_void_p":
                assert "*" in p, (symbol, p)
            elif kind == "c_int":
                assert p.startswith("int "), (symbol, p)
            else:
                assert p.startswith("float ") and "*" not in p, (symbol, p)
