"""Nothing the harness imports is JAX or the JAX package: top-level
module names compared whole (``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import os
import subprocess
import sys

from perfbench import harness

SCRIPT = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench
for mod in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    if ".tests" not in mod.name:
        importlib.import_module(mod.name)
from perfbench import harness
for path in (harness.BENCH_DIR / "metrics").glob("*.py"):
    harness.reader(path.stem)
import repro_torch.launch.steps, repro_torch.serving
import repro_torch.core.pipeline
print(" ".join(harness.forbidden_modules()))
"""


def test_harness_and_program_load_no_jax():
    env = dict(os.environ, USE_FLAX="0", USE_JAX="0")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT),
                                             src=str(harness.ROOT / "src"))],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert "repro" in harness.forbidden_modules()
