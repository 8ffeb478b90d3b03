"""The four example twins (``examples/port_*.py``) run their ``main`` on
the CPU (``--device cpu``) at their smallest arguments: the quickstart at
its defaults (it has no other flag), the collaborative serve over a real
socket on a port the OS assigns (and a saved plan served again), the
prune-and-split on the smoke Qwen2-7B with one DDPG episode, and the
training twin for 10 steps under its host mesh (a one-process gloo
group, destroyed on the way out) into a checkpoint both packages read.
Without ``--device`` each asks for the card and, with none here, raises
instead of falling back to the CPU."""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch.distributed as dist

from torch_parity import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("port_quickstart", "port_collaborative_serve",
         "port_prune_and_split", "port_train_transformer")


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for each test: the twins' small kernels only
    contend for the cores the other xdist workers use."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    res, out = _twin("port_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "optimal split: c=" in text and "predicted class:" in text
    assert res.plan is not None and 0 <= res.split.split_point <= len(
        res.cfg.layers)
    assert out["logits"].shape == (1, 38)
    assert np.isfinite(out["logits"]).all() and out["t_total"] > 0


def test_collaborative_serve_and_a_saved_plan(tmp_path, capsys):
    serve = _twin("port_collaborative_serve").main
    got = serve(["--requests", "2", "--port", str(free_port()), "--codec",
                 "int8", "--pipeline", "--device", "cpu"])
    assert len(got) == 2
    assert all(r["logits"].shape == (1, 38) and r["tx_bytes"] > 0
               for r in got)
    plan_dir = str(tmp_path / "plan")
    assert serve(["--save-plan", plan_dir, "--device", "cpu"]) is None
    again = serve(["--load-plan", plan_dir, "--requests", "1", "--port",
                   str(free_port()), "--device", "cpu"])
    assert len(again) == 1 and np.isfinite(again[0]["logits"]).all()
    text = capsys.readouterr().out
    assert "throughput" in text and "latency mean" in text


def test_prune_and_split_defaults_to_the_h100_profile(tmp_path, capsys):
    out = _twin("port_prune_and_split").main(
        ["--arch", "qwen2-7b", "--episodes", "1", "--device", "cpu",
         "--export-plan", str(tmp_path / "plan")])
    text = capsys.readouterr().out
    assert "profile=h100_edge_cloud" in text
    assert out["digest_match"]
    assert 0 <= out["greedy"].split_point <= 28
    assert out["greedy"].latency["T"] <= out["greedy"].table[0]["T"]


def test_train_transformer_under_the_host_mesh(tmp_path, capsys):
    import jax
    from repro.checkpoint import store as rstore
    from repro_torch.checkpoint import store
    ckpt = str(tmp_path / "ckpt" / "t")
    losses = _twin("port_train_transformer").main(
        ["--steps", "10", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt", ckpt])
    assert not dist.is_initialized()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert "mesh {'data': 1, 'model': 1} on cpu" in capsys.readouterr().out
    meta = store.load_metadata(ckpt)
    assert meta["steps"] == 10 and meta["final_loss"] == losses[-1]
    assert rstore.load_metadata(ckpt) == meta
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as rtr
    cfg = get_smoke_config("qwen2-7b").replace(dtype="float32")
    like = jax.eval_shape(lambda: rtr.init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    restored = rstore.restore(ckpt, like)
    assert all(np.isfinite(np.asarray(a)).all()
               for a in jax.tree_util.tree_leaves(restored))


@pytest.mark.parametrize("name", TWINS)
def test_twins_ask_for_the_card_by_default(name):
    args = {"port_collaborative_serve": ["--requests", "1", "--port",
                                         str(free_port())],
            "port_prune_and_split": ["--arch", "qwen2-7b"],
            "port_train_transformer": ["--steps", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(name).main(args)
    assert not dist.is_initialized()
