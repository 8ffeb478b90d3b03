"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, and the port's
entry points run on the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")


def _port_sources():
    """``chip_smoke.py``, the package's modules, then the example twins
    (``examples/port_*.py``), which are scripts, not modules."""
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out) + _twins()


def _twins():
    ex = os.path.join(REPO, "examples")
    return sorted(os.path.join(ex, f) for f in os.listdir(ex)
                  if f.startswith("port_") and f.endswith(".py"))


def _modules():
    mods = []
    for path in _port_sources()[1:len(_port_sources()) - len(_twins())]:
        rel = os.path.relpath(path, os.path.join(REPO, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_have_no_jax_or_reference_imports():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(_port_sources()) > 20


def test_connect_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch import serving
    from repro_torch.device import resolve_device
    from repro_torch.models.cnn import init_cnn_params, tiny_cnn_config
    cfg = tiny_cnn_config(num_classes=7, hw=32)
    plan = serving.DeploymentPlan.from_args(init_cnn_params(0, cfg), cfg, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.connect(plan, backend="local", device=device)
    assert resolve_device("cpu") == torch.device("cpu")
    with serving.connect(plan, backend="local", device="cpu") as sess:
        assert sess.device == torch.device("cpu")


def test_transformer_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs.qwen2_7b import smoke_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tr
    cfg = smoke_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tr.init_params(cfg),
                 lambda: tr.init_cache(cfg, 1, 8),
                 lambda: make_prefill_step(cfg),
                 lambda: make_decode_step(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tr.init_params(cfg, device="cpu")["embed"].device.type == "cpu"


def test_pipeline_and_streaming_entry_points_default_to_cuda(monkeypatch):
    """The paper's pipeline (``run_paper_pipeline``, ``train_cnn``,
    ``evaluate_topk``, the stage-2 reward), the pruning search
    (``search_pruning_policy``, ``init_agent``, replay draws) and the
    streaming backend run on the card unless given ``device="cpu"``, and
    raise without one before doing any work."""
    import numpy as np
    from repro_torch import serving
    from repro_torch.core import pipeline
    from repro_torch.core.collab.streaming import StreamingCollabRunner
    from repro_torch.core.partition.profiles import PAPER_PROFILE
    from repro_torch.core.pruning import ddpg
    from repro_torch.core.pruning.amc_env import PruningEnv, cnn_layer_descs
    from repro_torch.core.pruning.policy import search_pruning_policy
    from repro_torch.data.synthetic import PlantVillageSynthetic
    from repro_torch.models.cnn import init_cnn_params, tiny_cnn_config
    cfg = tiny_cnn_config(num_classes=38, width=0.2, hw=32)
    params = init_cnn_params(0, cfg)
    data = PlantVillageSynthetic(n_per_class=2, hw=32)
    plan = serving.DeploymentPlan.from_args(params, cfg, 6)
    env = PruningEnv(cnn_layer_descs(cfg), lambda a: 0.0)
    buf = ddpg.ReplayBuffer(11)
    buf.add(np.zeros(11), 0.5, 0.0, np.zeros(11), 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "run_paper_pipeline": lambda d: pipeline.run_paper_pipeline(
            cfg, data, device=d),
        "train_cnn": lambda d: pipeline.train_cnn(params, cfg, data,
                                                  device=d),
        "evaluate_topk": lambda d: pipeline.evaluate_topk(params, cfg, data,
                                                          device=d),
        "reward_evaluator": lambda d: pipeline.reward_evaluator(
            params, cfg, data, device=d),
        "make_train_step": lambda d: pipeline.make_train_step(
            cfg, None, device=d),
        "search_pruning_policy": lambda d: search_pruning_policy(
            env, episodes=1, device=d),
        "init_agent": lambda d: ddpg.init_agent(0, 11, device=d),
        "ReplayBuffer.sample": lambda d: buf.sample(
            np.random.RandomState(0), 2, device=d),
        "StreamingCollabRunner": lambda d: StreamingCollabRunner(
            params, cfg, 6, PAPER_PROFILE, device=d),
        "connect streaming": lambda d: serving.connect(
            plan, backend="streaming", device=d)}
    for name, call in calls.items():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(device)
    with serving.connect(plan, backend="streaming", device="cpu") as sess:
        assert sess.device == torch.device("cpu")
    assert ddpg.init_agent(0, 11, device="cpu").actor[0]["w"].device.type \
        == "cpu"


def test_calibration_entry_points_default_to_cuda(monkeypatch):
    """``calibrate_quant_edge`` and ``measure_cnn_layer_times`` time the
    layers on the card unless given ``device="cpu"``, and raise without
    one before timing anything."""
    import numpy as np
    from repro_torch.core.collab.quant import (QuantPolicy,
                                               calibrate_quant_edge,
                                               quantize_params)
    from repro_torch.core.partition.latency_model import (
        measure_cnn_layer_times)
    from repro_torch.models.cnn import init_cnn_params, tiny_cnn_config
    cfg = tiny_cnn_config(num_classes=7, hw=32)
    params = init_cnn_params(0, cfg)
    bank = quantize_params(params, cfg, QuantPolicy(8))
    x = np.zeros((1, 32, 32, 3), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"calibrate_quant_edge": lambda d: calibrate_quant_edge(
                 bank, cfg, x, repeats=1, device=d),
             "measure_cnn_layer_times": lambda d: measure_cnn_layer_times(
                 params, cfg, x, repeats=1, device=d)}
    for call in calls.values():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(device)
    n = len(cfg.layers)
    assert len(calls["measure_cnn_layer_times"]("cpu")) == n
    assert len(calls["calibrate_quant_edge"]("cpu").layer_s) == n
