"""The pod pipeline (``repro_torch.core.partition.pod_pipeline``) and the
serve steps on a mesh (``launch.steps.make_prefill_step`` /
``make_decode_step`` with ``mesh=``) against the reference and against
the port's own unsharded steps.

One spawn of two ``gloo`` ranks runs everything that needs two
processes: the two-pod pipeline on a (2, 1, 1) ("pod", "data", "model")
mesh for the smoke Qwen2-7B, Mamba2-2.7B and Mixtral-8x7B (float32, MoE
capacity raised so that nothing drops, two microbatches), held within
2e-3 of the reference's ``forward`` last-position logits (the check the
reference's own ``tests/test_pod_pipeline.py`` intends; its multi-pod
case cannot run on this host's JAX), and the mesh prefill and two decode
steps of Qwen2-7B and Mamba2-2.7B on (2, 1) and (1, 2) ("data", "model")
meshes against the one-process steps. One spawn of four ranks runs the
same pipelines with each stage on the split route: on (2, 1, 2) the
stage's heads, FFN columns, experts and SSD heads over "model" and the
hop a half of the activation's d_model; on (2, 2, 1) a microbatch's rows
over "data" (the MoE dispatch over both). On one rank the mesh steps
give the unsharded steps' bits, and the one-pod pipeline matches the
reference's passthrough.

This file imports no JAX at module level: the spawned ranks import it by
name; the reference's numbers come from the parent."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core.partition import pod_pipeline as pp
from repro_torch.interop import transformer_params_from_reference
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from repro_torch.sharding import specs as sh
from torch_ranks import init_group, spawn

PIPE_ARCHS = ("qwen2-7b", "mamba2-2.7b", "mixtral-8x7b")
SERVE_ARCHS = ("qwen2-7b", "mamba2-2.7b")
SERVE_MESHES = ((2, 1), (1, 2))
#: the four-rank spawn's ("pod", "data", "model") meshes
SPLIT_MESHES = ((2, 1, 2), (2, 2, 1))
B, S, M = 4, 16, 2
DECODE_STEPS = 2
#: seconds each spawn's ranks may take (about 30 alone)
DEADLINE = 400
#: the reference test's bound on the pipelined logits against ``forward``
PIPE_ATOL = 2e-3
#: float32: the mesh steps are the same sums as the one-process steps
#: over fewer rows, so within 64 eps of the largest logit
EPS32 = float(np.finfo(np.float32).eps)


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts) / cfg.moe.top_k))


def _cfg(arch):
    return _no_drop(tsmoke(arch).replace(dtype="float32", remat=False))


def _tokens(cfg, rows, cols, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, cols)).astype(np.int64)


def _unsharded_serve(cfg, params, tokens, steps):
    """[prefill logits, decode logits...] of the one-process steps."""
    pre = make_prefill_step(cfg, max_len=S + DECODE_STEPS, device="cpu")
    dec = make_decode_step(cfg, device="cpu")
    lg, cache = pre(params, {"tokens": tokens})
    out = [lg]
    for t in range(DECODE_STEPS):
        lg, cache = dec(params, cache, steps[:, t:t + 1])
        out.append(lg)
    return out


def _mesh_serve(cfg, params, tokens, steps, mesh):
    """The same through the mesh steps, the parameters distributed by
    ``param_specs``; each logit row gathered whole."""
    placed = sh.distribute(params, sh.param_specs(params, cfg, mesh), mesh)
    pre = make_prefill_step(cfg, max_len=S + DECODE_STEPS, device="cpu",
                            mesh=mesh)
    dec = make_decode_step(cfg, device="cpu", mesh=mesh)
    lg, cache = pre(placed, {"tokens": tokens})
    out = [lg.full_tensor()]
    for t in range(DECODE_STEPS):
        lg, cache = dec(placed, cache, steps[:, t:t + 1])
        out.append(lg.full_tensor())
    return out, cache


def _pipeline_logits(cfg, params, tokens, mesh, n_pods):
    sp = dict(params)
    sp["runs"] = [pp.stack_stage_params(params, cfg, n_pods)]
    placed = sh.distribute(sp, pp.stage_param_specs(sp, cfg, mesh), mesh)
    step = pp.make_split_serve_step(cfg, n_pods, M, mesh, device="cpu")
    return step(placed, {"tokens": tokens})


def _rank(rank: int, port: int, inputs: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    init_group(rank, 2, port)
    try:
        data = torch.load(inputs, weights_only=False)
        got = {}
        mesh = init_device_mesh("cpu", (2, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        for arch in PIPE_ARCHS:
            params = transformer_params_from_reference(data[arch])
            got[arch] = _pipeline_logits(_cfg(arch), params,
                                         data["tokens"][arch], mesh, 2)
        for shape in SERVE_MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for arch in SERVE_ARCHS:
                params = transformer_params_from_reference(data[arch])
                got[(arch, shape)], _ = _mesh_serve(
                    _cfg(arch), params, data["serve"][arch][0],
                    data["serve"][arch][1], mesh)
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _split_ranks(rank: int, port: int, inputs: str, out: str) -> None:
    """A rank of the four-rank spawn: the two-pod pipeline of every
    ``PIPE_ARCHS`` on each of ``SPLIT_MESHES``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    init_group(rank, 4, port)
    try:
        data = torch.load(inputs, weights_only=False)
        got = {}
        for shape in SPLIT_MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("pod", "data", "model"))
            for arch in PIPE_ARCHS:
                params = transformer_params_from_reference(data[arch])
                got[(arch, shape)] = _pipeline_logits(
                    _cfg(arch), params, data["tokens"][arch], mesh, 2)
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def shared():
    """Numpy parameters (``transformer_params_np``) and tokens of every
    arch the file runs, made in the parent."""
    from repro.configs import registry as rreg
    from torch_parity import transformer_params_np
    data = {"tokens": {}, "serve": {}}
    for i, arch in enumerate(dict.fromkeys(PIPE_ARCHS + SERVE_ARCHS)):
        cr = _no_drop(rreg.get_smoke_config(arch).replace(
            dtype="float32", remat=False))
        data[arch] = transformer_params_np(cr, seed=i)
        data["tokens"][arch] = _tokens(cr, B, S, 10 + i)
        data["serve"][arch] = (_tokens(cr, 2, S, 20 + i),
                               _tokens(cr, 2, DECODE_STEPS, 30 + i))
    return data


@pytest.fixture(scope="module")
def two_ranks(shared, tmp_path_factory):
    from torch_parity import free_port
    out = str(tmp_path_factory.mktemp("pods"))
    inputs = os.path.join(out, "inputs.pt")
    torch.save(shared, inputs)
    spawn(_rank, (free_port(), inputs, out), 2, DEADLINE)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def four_ranks(shared, tmp_path_factory):
    from torch_parity import free_port
    out = str(tmp_path_factory.mktemp("split_pods"))
    inputs = os.path.join(out, "inputs.pt")
    torch.save({k: shared[k] for k in PIPE_ARCHS + ("tokens",)}, inputs)
    spawn(_split_ranks, (free_port(), inputs, out), 4, DEADLINE)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def reference_last(shared):
    """The reference's ``forward`` logits at the last position, by arch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as rreg
    from repro.models import transformer as rtr
    out = {}
    for arch in PIPE_ARCHS:
        cr = _no_drop(rreg.get_smoke_config(arch).replace(
            dtype="float32", remat=False))
        ref, _ = rtr.forward(jax.tree_util.tree_map(jnp.asarray,
                                                    shared[arch]), cr,
                             {"tokens": jnp.asarray(
                                 shared["tokens"][arch].astype(np.int32))})
        out[arch] = np.asarray(ref[:, -1])
    return out


def test_pipeline_supported_table_matches_reference():
    from repro.configs import registry as rreg
    from repro.core.partition import pod_pipeline as rpp
    for arch in ARCH_IDS:
        for rget, tget_ in ((rreg.get_smoke_config, tsmoke),
                            (rreg.get_config, tget)):
            assert pp.pipeline_supported(tget_(arch)) == \
                rpp.pipeline_supported(rget(arch)), arch
    assert {a for a in ARCH_IDS if pp.pipeline_supported(tget(a))} == {
        "qwen2-7b", "gemma-7b", "qwen1.5-4b", "nemotron-4-340b",
        "mamba2-2.7b", "mixtral-8x7b", "hubert-xlarge", "qwen2-vl-7b"}


@pytest.mark.parametrize("n_stages", (1, 2))
@pytest.mark.parametrize("arch", PIPE_ARCHS + ("hubert-xlarge",))
def test_stack_stage_params_shapes_match_reference(arch, n_stages):
    """The restacked run has the reference's (n, L/n, ...) shapes leaf
    for leaf, and is a view of the stacked tensors."""
    import jax
    from repro.configs import registry as rreg
    from repro.core.partition import pod_pipeline as rpp
    from repro.models import transformer as rtr
    cr = rreg.get_smoke_config(arch)
    want = jax.eval_shape(lambda: rpp.stack_stage_params(
        rtr.init_params(cr, jax.random.PRNGKey(0)), cr, n_stages))
    cfg = tsmoke(arch)
    params = ttr.init_params(cfg, device="cpu")
    got = pp.stack_stage_params(params, cfg, n_stages)
    from repro.sharding.specs import path_keys as rkeys
    want_shapes = {rkeys(p): tuple(leaf.shape) for p, leaf in
                   jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {k: tuple(t.shape) for k, t in sh_leaves(got)} == want_shapes
    for (_, g), (_, w) in zip(sh_leaves(got), sh_leaves(params["runs"][0])):
        assert g.untyped_storage()._cdata == w.untyped_storage()._cdata


def sh_leaves(tree):
    out = []
    sh.tree_map_with_path(lambda p, t: out.append((sh.path_keys(p), t)),
                          tree)
    return out


def test_stack_stage_params_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        pp.stack_stage_params(ttr.init_params(tsmoke("zamba2-1.2b"),
                                              device="cpu"),
                              tsmoke("zamba2-1.2b"), 1)
    cfg = tsmoke("qwen2-7b")
    with pytest.raises(ValueError):
        pp.stack_stage_params(ttr.init_params(cfg, device="cpu"), cfg,
                              cfg.num_layers + 1)


def test_one_pod_passthrough_matches_reference(shared):
    """n_pods = 1 on a one-rank gloo (1, 1, 1) mesh against the
    reference's ``make_split_serve_step(cfg, 1, 2, mesh)`` on the same
    tensors (``tests/test_pod_pipeline.py::test_single_pod_passthrough``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import registry as rreg
    from repro.core.partition import pod_pipeline as rpp
    from torch_parity import stack_tol
    arch = "qwen2-7b"
    cr = _no_drop(rreg.get_smoke_config(arch).replace(dtype="float32",
                                                      remat=False))
    pn, tok = shared[arch], shared["tokens"][arch]
    rp = jax.tree_util.tree_map(jnp.asarray, pn)
    sp = dict(rp)
    sp["runs"] = [rpp.stack_stage_params(rp, cr, 1)]
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                 ("pod", "data", "model"))
    with jmesh:
        want = np.asarray(jax.jit(rpp.make_split_serve_step(cr, 1, M, jmesh))(
            sp, {"tokens": jnp.asarray(tok.astype(np.int32))}))
    with host_mesh("cpu", pod_axis=True) as mesh:
        got = _pipeline_logits(_cfg(arch), transformer_params_from_reference(
            pn), tok, mesh, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= stack_tol(want, "float32")


def test_two_pod_pipeline_matches_reference_forward(two_ranks,
                                                    reference_last):
    """Both pods' logits are the same bits, within 2e-3 of the
    reference's ``forward`` at the last position."""
    for arch in PIPE_ARCHS:
        want = reference_last[arch]
        got = [r[arch] for r in two_ranks]
        assert torch.equal(got[0], got[1]), arch
        err = float(np.abs(got[0].numpy() - want).max())
        assert err < PIPE_ATOL, (arch, err)


@pytest.mark.parametrize("shape", SPLIT_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", PIPE_ARCHS)
def test_split_stage_pipeline_matches_reference_forward(arch, shape,
                                                        four_ranks,
                                                        reference_last):
    """Each stage on the split route, two pods of two ranks: all four
    ranks' logits are the same bits, within 2e-3 of the reference's
    ``forward`` at the last position."""
    got = [r[(arch, shape)] for r in four_ranks]
    assert got[0].shape == reference_last[arch].shape
    for g in got[1:]:
        assert torch.equal(g, got[0])
    err = float(np.abs(got[0].numpy() - reference_last[arch]).max())
    assert err < PIPE_ATOL, err


@pytest.mark.parametrize("shape", SERVE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serve_steps_on_two_ranks(arch, shape, shared, two_ranks):
    """The mesh prefill and decode steps on two ranks against the
    one-process steps, every logit row within 64 eps of the largest."""
    tok, steps = (torch.as_tensor(a) for a in shared["serve"][arch])
    want = _unsharded_serve(_cfg(arch), transformer_params_from_reference(
        shared[arch]), tok, steps)
    for r in two_ranks:
        got = r[(arch, shape)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            tol = 64 * EPS32 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("arch", ("qwen2-7b", "mamba2-2.7b", "zamba2-1.2b",
                                  "mixtral-8x7b", "qwen2-vl-7b"))
def test_one_rank_mesh_serve_steps_give_the_unsharded_bits(arch):
    """On a one-rank gloo mesh the mesh prefill, its cache and two decode
    steps are the unsharded steps' bits."""
    from torch_parity import model_batch_np
    cfg = _cfg(arch)
    params = ttr.init_params(cfg, 3, device="cpu")
    batch = model_batch_np(cfg, 2, S)
    steps = torch.as_tensor(_tokens(cfg, 2, DECODE_STEPS, 5))
    pre = make_prefill_step(cfg, max_len=S + (cfg.vision_tokens or 0)
                            + DECODE_STEPS, device="cpu")
    dec = make_decode_step(cfg, device="cpu")
    lg, cache = pre(params, batch)
    want = [lg]
    for t in range(DECODE_STEPS):
        lg, cache = dec(params, cache, steps[:, t:t + 1])
        want.append(lg)
    with host_mesh("cpu") as mesh:
        placed = sh.distribute(params, sh.param_specs(params, cfg, mesh),
                               mesh)
        mpre = make_prefill_step(cfg, max_len=S + (cfg.vision_tokens or 0)
                                 + DECODE_STEPS, device="cpu", mesh=mesh)
        mdec = make_decode_step(cfg, device="cpu", mesh=mesh)
        lg, mcache = mpre(placed, batch)
        got = [lg.to_local()]
        for t in range(DECODE_STEPS):
            lg, mcache = mdec(placed, mcache, steps[:, t:t + 1])
            got.append(lg.to_local())
        got_cache = [t.to_local() for _, t in sh_leaves(mcache)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    want_cache = [t for _, t in sh_leaves(cache)]
    assert len(got_cache) == len(want_cache)
    for g, w in zip(got_cache, want_cache):
        assert torch.equal(g, w)


def test_split_serve_and_mesh_steps_default_to_cuda(monkeypatch):
    cfg = tsmoke("qwen2-7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pp.make_split_serve_step(cfg, 1, 2, None),
                 lambda: make_prefill_step(cfg, mesh=object()),
                 lambda: make_decode_step(cfg, mesh=object())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
