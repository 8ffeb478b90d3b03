"""The port's sharding planner (``repro_torch.sharding.specs``,
``sharding.constraints``) against the reference's, leaf for leaf.

The port's specs run on fake-group ``DeviceMesh``es (``torch.distributed``'s
``fake`` backend: any world size in one process, no collective runs) of
shape (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data", "model"),
the reference's on its stand-in meshes of one repeated CPU device
(``tests/test_sharding.py``): for every registry smoke config, the
parameter specs, the AdamW and SGD state specs, request and training
batches (``embeds``, ``vision_embeds`` and the (3, B, S)
``mrope_positions`` included) and every cache family. Qwen2-7B and
DeepSeek-V3 at full shapes on (16, 16): the port's trees on the ``meta``
device, the reference's from ``jax.eval_shape``. The placements lay out
(pod, data) shards pod-major, as JAX does. Specs compare exactly; each
fixture destroys the process group it starts.
"""
from __future__ import annotations

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import registry as rreg
from repro.models import transformer as rtr
from repro.optim import adamw as radamw
from repro.optim import constant as rconstant
from repro.optim import sgd_momentum as rsgd
from repro.sharding import specs as rspecs
from repro_torch.configs import registry as treg
from repro_torch.data.requests import request_batch
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.optim.schedules import constant
from repro_torch.sharding import constraints as tcon
from repro_torch.sharding import specs as tspecs

SMALL = {"2x4": ((2, 4), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FULL = ((16, 16), ("data", "model"))


def _fake_mesh(shape, names, rank=0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture
def fake_group():
    """Start fake groups through the returned function; whatever is
    started is destroyed at teardown."""
    def start(shape, names, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        return _fake_mesh(shape, names, rank)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_mesh(shape, names):
    n = math.prod(shape)
    return JaxMesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


def _ref_leaves(specs):
    """[(path keys, spec as a tuple)] of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(rspecs.path_keys(p), tuple(s)) for p, s in flat]


def _port_leaves(specs):
    out = []
    tspecs.tree_map_with_path(
        lambda p, s: out.append((tspecs.path_keys(p), tuple(s))), specs,
        is_leaf=tspecs._is_spec)
    return out


def _assert_same(port_specs, ref_specs):
    """The same (path, spec) leaves; JAX flattens a dict in sorted key
    order, the port in insertion order, so they compare by path."""
    got, want = _port_leaves(port_specs), _ref_leaves(ref_specs)
    assert len(got) == len(want) and dict(got) == dict(want)


def _ref_params(cfg):
    return jax.eval_shape(lambda: rtr.init_params(cfg, jax.random.PRNGKey(0)))


def _configs(arch, full=False):
    get_r = rreg.get_config if full else rreg.get_smoke_config
    get_t = treg.get_config if full else treg.get_smoke_config
    return get_r(arch), get_t(arch)


@pytest.mark.parametrize("mesh_id", sorted(SMALL))
@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_param_and_opt_state_specs_match_reference(arch, mesh_id,
                                                   fake_group):
    """Every smoke config's parameter specs, then the AdamW (``m``,
    ``v``) and SGD (``mom``) state specs that mirror them, equal the
    reference's leaf for leaf, paths included."""
    shape, names = SMALL[mesh_id]
    mesh = fake_group(shape, names)
    jmesh = _jax_mesh(shape, names)
    rcfg, tcfg = _configs(arch)
    rp = _ref_params(rcfg)
    tp = ttr.init_params(tcfg, device="meta")
    rps = rspecs.param_specs(rp, rcfg, jmesh)
    tps = tspecs.param_specs(tp, tcfg, mesh)
    _assert_same(tps, rps)
    for ropt, topt in ((radamw(rconstant(1e-3)), adamw(constant(1e-3))),
                       (rsgd(rconstant(1e-3)), sgd_momentum(constant(1e-3)))):
        _assert_same(tspecs.opt_state_specs(topt.init(tp), tps),
                     rspecs.opt_state_specs(jax.eval_shape(ropt.init, rp),
                                            rps))


def _batches(cfg):
    """Request and training batches at batch sizes the data axes divide,
    do not divide (the sequence taken instead) and neither (replicated):
    a VLM's with and without its grid ids, an audio config's embeddings;
    labels beside them."""
    out = []
    for B, S in ((8, 16), (2, 16), (1, 16), (3, 17)):
        S = S + (cfg.vision_tokens or 0)
        b = request_batch(cfg, B, S, np.random.default_rng(0))
        b["labels"] = np.zeros((B, S - (cfg.vision_tokens or 0)), np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("mesh_id", sorted(SMALL))
@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_batch_specs_match_reference(arch, mesh_id, fake_group):
    shape, names = SMALL[mesh_id]
    mesh = fake_group(shape, names)
    jmesh = _jax_mesh(shape, names)
    rcfg, tcfg = _configs(arch)
    for b in _batches(tcfg):
        _assert_same(tspecs.batch_specs(b, tcfg, mesh),
                     rspecs.batch_specs(b, rcfg, jmesh))


def _hybrid_ssm_runs(ref_leaves):
    """A hybrid's reference cache keeps its ssm run as (groups, period)
    and a tail; the port's stacks the run flat. Each reference leaf's
    spec with its leading layer dims folded into one, for the port's
    layout (every leading entry must be None)."""
    out = []
    for keys, spec in ref_leaves:
        if len(keys) >= 4 and keys[0] == "runs" and keys[2] in ("0", "1") \
                and keys[-1] in ("conv", "state"):
            lead = 2 if keys[2] == "0" else 1
            assert spec[:lead] == (None,) * lead
            keys, spec = (keys[0], keys[1], keys[-1]), (None,) + spec[lead:]
        out.append((keys, spec))
    return out


#: the configs with a decode cache (an encoder-only config has none)
CACHED = [a for a in rreg.ARCH_IDS if rreg.get_smoke_config(a).causal]


@pytest.mark.parametrize("mesh_id", sorted(SMALL))
@pytest.mark.parametrize("arch", CACHED)
def test_cache_specs_match_reference(arch, mesh_id, fake_group):
    """KV, MLA, SSM and a hybrid's shared-block caches at batch 8 and 1
    (the sequence over the data axes), leaf for leaf; a hybrid's ssm run
    by its per-layer layout (``_hybrid_ssm_runs``)."""
    shape, names = SMALL[mesh_id]
    mesh = fake_group(shape, names)
    jmesh = _jax_mesh(shape, names)
    rcfg, tcfg = _configs(arch)
    for B in (8, 1):
        rc = jax.eval_shape(lambda: rtr.init_cache(rcfg, B, 64))
        tc = ttr.init_cache(tcfg, B, 64, device="meta")
        want = _ref_leaves(rspecs.cache_specs(rc, rcfg, jmesh))
        got = _port_leaves(tspecs.cache_specs(tc, tcfg, mesh))
        if tcfg.shared_attn_period:
            want = _hybrid_ssm_runs(want)
            got = [(k if k[0] != "runs" or k[-1] not in ("conv", "state")
                    else (k[0], k[1], k[-1]), s) for k, s in got]
            # the reference's tail run adds leaves the flat stack has not
            assert set(got) <= set(want)
            assert {k for k, _ in got} == {k for k, _ in want}
        else:
            assert len(got) == len(want) and dict(got) == dict(want)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v3-671b"])
def test_full_shapes_on_the_production_mesh(arch, fake_group):
    """Full-size Qwen2-7B (28 heads: 28 and 3584 / 28-wide dims that 16
    does not divide fall back to replication) and DeepSeek-V3 (256
    experts, MLA ranks, the MTP block) on a (16, 16) mesh: params, AdamW
    state, a 4096-token batch of 32 and of 1, and the decode cache."""
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = make_production_mesh()
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == FULL
    jmesh = _jax_mesh(*FULL)
    rcfg, tcfg = _configs(arch, full=True)
    rp = _ref_params(rcfg)
    tp = ttr.init_params(tcfg, device="meta")
    rps = rspecs.param_specs(rp, rcfg, jmesh)
    tps = tspecs.param_specs(tp, tcfg, mesh)
    _assert_same(tps, rps)
    _assert_same(tspecs.opt_state_specs(adamw(constant(1e-3)).init(tp), tps),
                 rspecs.opt_state_specs(
                     jax.eval_shape(radamw(rconstant(1e-3)).init, rp), rps))
    for B in (32, 1):
        b = {"tokens": np.zeros((B, 4096), np.int32),
             "labels": np.zeros((B, 4096), np.int32)}
        _assert_same(tspecs.batch_specs(b, tcfg, mesh),
                     rspecs.batch_specs(b, rcfg, jmesh))
    rc = jax.eval_shape(lambda: rtr.init_cache(rcfg, 32, 4096))
    tc = ttr.init_cache(tcfg, 32, 4096, device="meta")
    _assert_same(tspecs.cache_specs(tc, tcfg, mesh),
                 rspecs.cache_specs(rc, rcfg, jmesh))


def test_production_meshes_run_over_the_current_group(fake_group):
    """``make_production_mesh`` takes the group that exists: (16, 16)
    ("data", "model") on 256 ranks, (2, 16, 16) with "pod" on 512, both
    on the CPU device type of the fake backend."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi, world, shape, names in (
            (False, 256, (16, 16), ("data", "model")),
            (True, 512, (2, 16, 16), ("pod", "data", "model"))):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = make_production_mesh(multi_pod=multi)
        assert (tuple(mesh.shape), mesh.mesh_dim_names,
                mesh.device_type) == (shape, names, "cpu")


def _jax_offsets(global_shape, spec, sizes, coord):
    """A shard's offset by JAX's rule: a dim over axes (a1, a2, ...) is cut
    into prod(sizes) blocks, the block index mixed-radix over the axes'
    coordinates, the first axis the major digit."""
    out = []
    for dim, ax in zip(global_shape, tuple(spec) + (None,) * len(
            global_shape)):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        out.append(idx * (dim // n))
    return tuple(out)


SPECS = [tspecs.P(("pod", "data"), "model"), tspecs.P("model", ("pod", "data")),
         tspecs.P(None, ("pod", "data"), "model"), tspecs.P("data", None),
         tspecs.P(("pod", "data", "model"),)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_offsets_follow_jax_major_to_minor(spec, fake_group):
    """Every rank of a (2, 2, 2) mesh: the local shape and offset DTensor
    gives ``to_shardings``' placements equal the block JAX gives the
    spec's device (its axes major to minor in the spec's order)."""
    shape, names = SMALL["2x2x2"]
    gshape = (16, 8, 4)[:len(spec)] if len(spec) > 1 else (16,)
    for rank in range(8):
        mesh = fake_group(shape, names, rank)
        coord = dict(zip(names, mesh.get_coordinate()))
        m, pl = tspecs.to_shardings([spec], mesh)[0]
        assert m is mesh
        lshape, offset = compute_local_shape_and_global_offset(gshape, mesh,
                                                               pl)
        sizes = dict(zip(names, shape))
        assert offset == _jax_offsets(gshape, spec, sizes, coord)
        assert lshape == tuple(
            d // math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                              else (ax,) if ax else ()))
            for d, ax in zip(gshape, tuple(spec) + (None,) * 3))


def test_placements_and_distribute(fake_group):
    """``placements``: Shard on each named mesh axis, Replicate on the
    rest; ``distribute`` keeps each rank's slice (rank 5 of (2, 2, 2) is
    pod 1, data 0, model 1) and passes a counter through."""
    shape, names = SMALL["2x2x2"]
    mesh = fake_group(shape, names, rank=5)
    assert tspecs.placements(tspecs.P(("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert tspecs.placements(tspecs.P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    t = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    tree = {"w": t, "step": 3}
    out = tspecs.distribute(tree, {"w": tspecs.P(("pod", "data"), "model"),
                                   "step": tspecs.P()}, mesh)
    assert out["step"] == 3
    assert isinstance(out["w"], DTensor)
    assert torch.equal(out["w"].to_local(), t[8:12, 2:4])
    assert torch.equal(tspecs.local_slice(t, tspecs.P(("pod", "data"),
                                                      "model"), mesh),
                       t[8:12, 2:4])


def test_maybe_constrain_and_data_axes_spec(fake_group):
    """Outside a mesh both are inert; inside one a plain tensor passes
    through untouched and a DTensor is laid out by the spec, axes the
    mesh lacks or that ``declared_manual_axes`` took dropped."""
    x = torch.ones(8, 4)
    assert tcon.maybe_constrain(x, tspecs.P("data", "model")) is x
    assert tcon.data_axes_spec() is None
    mesh = fake_group(*SMALL["2x4"])
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    assert tcon.maybe_constrain(d, tspecs.P("data", "model")) is d
    with tcon.use_mesh(mesh):
        assert tcon.current_mesh() is mesh
        assert tcon.data_axes_spec() == "data"
        assert tcon.maybe_constrain(x, tspecs.P("data", "model")) is x
        got = tcon.maybe_constrain(d, tspecs.P("data", "model"))
        assert got.placements == (Shard(0), Shard(1))
        got = tcon.maybe_constrain(d, tspecs.P(("pod", "data"), "model"))
        assert got.placements == (Replicate(), Shard(1))
        assert tcon.maybe_constrain(d, tspecs.P("pod", None)) is d
        with tcon.declared_manual_axes("data"):
            assert tcon.data_axes_spec() is None
            got = tcon.maybe_constrain(d, tspecs.P("data", "model"))
            assert got.placements == (Replicate(), Shard(1))
    assert tcon.current_mesh() is None
    dist.destroy_process_group()
    mesh3 = _fake_mesh(*SMALL["2x2x2"])
    with tcon.use_mesh(mesh3):
        assert tcon.data_axes_spec() == ("pod", "data")


def test_mesh_axes_both_meshes(fake_group):
    assert tspecs.mesh_axes(fake_group(*SMALL["2x4"])) == (("data",),
                                                           "model")
    assert tspecs.mesh_axes(fake_group(*SMALL["2x2x2"])) == (
        ("pod", "data"), "model")


def test_spec_values_are_the_reference_tuples():
    """A port spec is a plain tuple of its entries, like ``P`` of JAX."""
    sp = tspecs.P(("pod", "data"), None, "model")
    assert sp == (("pod", "data"), None, "model")
    assert tuple(jax.sharding.PartitionSpec(("pod", "data"), None,
                                            "model")) == sp
    assert tspecs.P() == ()
    assert list(itertools.chain(sp)) == [("pod", "data"), None, "model"]
