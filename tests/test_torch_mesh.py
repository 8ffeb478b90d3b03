"""The sharded train step (``launch.steps.make_train_step(mesh=...)``) on
``gloo`` meshes of two CPU processes against the port's own one-process
step: one spawn of two ranks runs a (1, 2) ("data", "model") mesh, where
the weights shard over "model" and both ranks see the whole batch, and a
(2, 1) mesh, where the weights shard over "data" (FSDP-style) and each
rank takes one row of the batch; two AdamW steps of the smoke Qwen2-7B
in float32 with the global-norm clip active. The one-rank mesh of
``host_mesh`` gives the unsharded step's bits.

This file imports no JAX: the spawned ranks import it by name."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.tokens import MarkovTokens
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import global_sq_norm, tree_leaves
from repro_torch.optim.schedules import constant
from repro_torch.sharding import specs as sh
from torch_ranks import init_group, spawn

MESHES = ((1, 2), (2, 1))
#: seconds the 2 ranks may take (about 10 alone)
DEADLINE = 300
STEPS = 2
LR = 1e-3
#: AdamW's eps: near the gradients' own size (the clipped gradient's
#: entries are ~1e-3), so an update is ~lr x g / eps, not lr x sign(g): it
#: moves with the clip's scale (a norm over one shard would move every
#: update) and not with the rounding of an entry near zero (at the default
#: 1e-8 such an entry's update is a coin toss of +-lr)
EPS = 1e-3
#: float32: each rank's loss and gradients are the same sums as the
#: one-process step's in another grouping (half the batch, then the two
#: halves added), and the clip's norm is summed shard by shard, so the
#: metrics agree within 1e-6 relative (measured: 2e-7), and every
#: parameter within 4 ulp of its leaf's largest entry plus 1e-4 of one
#: step's lr (measured: 1 ulp, and 1e-5 lr on the zero-initialised
#: biases): a wrong gradient, a missing reduction or a shard's own norm
#: in the clip moves updates by a good share of lr
METRIC_RTOL = 1e-6
PARAM_ULPS = 4
UPDATE_RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def _setup():
    cfg = get_smoke_config("qwen2-7b").replace(dtype="float32")
    params = tr.init_params(cfg, 0, device="cpu")
    batch = MarkovTokens(cfg.vocab_size, seed=0).batch(2, 16, 0)
    batch["labels"][0, 3] = -1      # the two rows count unequal tokens
    return cfg, params, batch


def _run(cfg, params, batch, mesh=None):
    """(params, metrics) after ``STEPS`` AdamW steps, on ``mesh`` or not;
    the parameters gathered whole."""
    opt = adamw(constant(LR), eps=EPS)
    state = opt.init(params)
    if mesh is not None:
        ps = sh.param_specs(params, cfg, mesh)
        params = sh.distribute(params, ps, mesh)
        state = sh.distribute(state, sh.opt_state_specs(state, ps), mesh)
    step = make_train_step(cfg, opt, device="cpu", mesh=mesh)
    for _ in range(STEPS):
        params, state, metrics = step(params, state, batch)
    if mesh is not None:
        params = sh.tree_map_with_path(lambda _, p: p.full_tensor(), params)
    return params, {k: float(v) for k, v in metrics.items()}


def _rank(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)        # two ranks beside the other workers
    from torch.distributed.device_mesh import init_device_mesh
    init_group(rank, 2, port)
    try:
        cfg, params, batch = _setup()
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            got, metrics = _run(cfg, params, batch, mesh)
            if rank == 0:
                torch.save({"params": [t.clone() for t in
                                       tree_leaves(got)],
                            "metrics": metrics},
                           os.path.join(out, f"{shape[0]}x{shape[1]}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    from torch_parity import free_port
    out = str(tmp_path_factory.mktemp("mesh"))
    spawn(_rank, (free_port(), out), 2, DEADLINE)
    return {shape: torch.load(os.path.join(out, f"{shape[0]}x{shape[1]}.pt"))
            for shape in MESHES}


@pytest.fixture(scope="module")
def one_process():
    cfg, params, batch = _setup()
    return _run(cfg, params, batch)


def test_the_clip_is_active():
    """The smoke model's gradient norm at step 0 is above AdamW's clip of
    1.0, so the steps below scale by the global norm."""
    cfg, params, batch = _setup()
    _, grads = loss_and_grads(params, cfg, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
    assert float(torch.sqrt(global_sq_norm(grads))) > 1.0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_one_process(shape, two_rank_runs, one_process):
    want_p, want_m = one_process
    got = two_rank_runs[shape]
    assert set(got["metrics"]) == set(want_m)
    for k, v in want_m.items():
        assert abs(got["metrics"][k] - v) <= METRIC_RTOL * max(abs(v), 1.0)
    want = tree_leaves(want_p)
    assert len(got["params"]) == len(want)
    for g, w in zip(got["params"], want):
        assert g.shape == w.shape
        tol = PARAM_ULPS * EPS32 * float(w.abs().max()) + UPDATE_RTOL * LR
        assert float((g - w).abs().max()) <= tol


def test_distribute_wraps_a_whole_slice_without_a_copy():
    """On a one-rank mesh every leaf's slice is the whole tensor, and
    ``distribute`` wraps the caller's tensor itself: the DTensor's local
    tensor and the caller's share their memory (so neither may be written
    in place while the other is in use), and no leaf is copied."""
    cfg, params, _ = _setup()
    with host_mesh("cpu") as mesh:
        placed = sh.distribute(params, sh.param_specs(params, cfg, mesh),
                               mesh)
        for t, d in zip(tree_leaves(params), tree_leaves(placed)):
            assert d.to_local().data_ptr() == t.data_ptr()
            assert d.shape == t.shape and d.stride() == t.stride()


def test_one_rank_mesh_gives_the_unsharded_bits(one_process):
    want_p, want_m = one_process
    cfg, params, batch = _setup()
    with host_mesh("cpu") as mesh:
        got_p, got_m = _run(cfg, params, batch, mesh)
    assert got_m == want_m
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(g, w)
