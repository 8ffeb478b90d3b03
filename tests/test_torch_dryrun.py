"""The port's dry run (``repro_torch.launch.specs``, ``launch.dryrun``,
``launch.dryrun_matrix`` and the counter half of ``roofline.analysis``)
against the reference's tables and counts.

* Specs: ``supported`` over all 10 archs x 4 shapes equals the
  reference's (33 live pairs); ``input_specs``' ``meta`` trees have the
  shapes and dtypes of the reference's ``jax.eval_shape`` trees for every
  full config (token ids int64 where the reference's are int32; a hybrid's
  ssm cache compared field by field in total, since the reference keeps it
  as (groups, period) + tail).
* Counts: ``active_params``, ``model_flops``, ``analytic_memory`` (the
  reference given a stand-in with ``devices.size``) and ``est_cost``
  equal the reference's for every (arch, shape).
* The counter: on a fake 4-rank mesh under ``FakeTensorMode``, a
  DTensor's all-gather and a ``batch_isend_irecv`` send count the bytes
  computed by hand, a matmul its FLOPs, the live storages their peak.
* ``run_one`` and ``run_split_serve`` at smoke size on small fake meshes
  write records with the reference's keys (and the port's
  ``data_split``) into the directory given and nowhere else; every arch's train, prefill and decode steps trace under
  ``FakeTensorMode`` (the MoE count, M-RoPE band ids, the train step's
  token share and ``init_params``' fill read no value of a fake tensor).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun, dryrun_matrix
from repro_torch.launch import specs as tspecs
from repro_torch.roofline import analysis, hw
from repro_torch.sharding import specs as sh
from repro_torch.sharding.tensor_parallel import ROUTE_SPLIT
from torch_parity import one_thread  # noqa: F401 (autouse)

SHAPE_NAMES = tuple(tspecs.SHAPES)
SMALL = (2, 2)
#: every record's keys; ``MOE_KEYS`` only an MoE config's records hold
MOE_KEYS = {"moe_dispatch_sizes", "moe_forward"}
RECORD_KEYS = {"arch", "shape", "mesh", "grad_accum", "chips", "status",
               "data_split", *MOE_KEYS,
               "scan_counted", "trace_s", "backend", "token_dtype",
               "model_axis", "memory_analysis", "analytic_memory",
               "cost_analysis", "collectives", "roofline", "params_total",
               "params_active", "model_flops", "useful_flops_ratio",
               "moment_dtype"}
ROOFLINE_KEYS = {"flops", "hbm_bytes", "flops_global", "hbm_bytes_global",
                 "collective_bytes_per_chip", "chips", "t_compute_s",
                 "t_memory_s", "t_collective_s", "dominant"}


@pytest.fixture
def no_group():
    """No process group before or after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_dryrun():
    """The reference's ``launch.dryrun``: its import sets ``XLA_FLAGS``
    for a 512-device host, which must reach neither this process's JAX
    (started first, here) nor later tests, so the variable is restored."""
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return rdry


def _ref_leaves(tree):
    import jax
    from repro.sharding.specs import path_keys
    return {path_keys(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    out = {}
    sh.tree_map_with_path(lambda p, t: out.__setitem__(
        sh.path_keys(p), (tuple(t.shape), str(t.dtype).removeprefix(
            "torch."))), tree)
    return out


def _by_field(leaves):
    """{field: (total entries, dtypes)} of a cache's leaves."""
    out = {}
    for keys, (shape, dt) in leaves.items():
        n, dts = out.get(keys[-1], (0, set()))
        out[keys[-1]] = (n + math.prod(shape), dts | {dt})
    return out


def test_supported_table_matches_reference():
    from repro.configs import registry as rreg
    from repro.launch import specs as rspecs
    assert tspecs.SHAPES == rspecs.SHAPES and tspecs.LONG_OK == rspecs.LONG_OK
    live = 0
    for arch in treg.ARCH_IDS:
        for shape in SHAPE_NAMES:
            got = tspecs.supported(treg.get_config(arch), shape)
            assert got == rspecs.supported(rreg.get_config(arch), shape)
            assert tspecs.mode_of(shape) == rspecs.mode_of(shape)
            live += got[0]
    assert live == 33


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_input_specs_match_eval_shape(arch):
    """Every shape's params, batch and (decode) cache, leaf by leaf."""
    from repro.configs import registry as rreg
    from repro.launch import specs as rspecs
    cr, ct = rreg.get_config(arch), treg.get_config(arch)
    token = {"int32": "int64"}
    for shape in SHAPE_NAMES:
        want, got = rspecs.input_specs(cr, shape), tspecs.input_specs(ct, shape)
        assert set(want) == set(got)
        for key in want:
            w, g = _ref_leaves(want[key]), _port_leaves(got[key])
            if key in ("batch", "tokens"):
                w = {p: (s, token.get(d, d) if p[-1:] != ("mrope_positions",)
                         else d) for p, (s, d) in w.items()}
            if key == "cache" and ct.shared_attn_period:
                assert _by_field(g) == _by_field(w)
            else:
                assert g == w, (shape, key)
        assert all(t.device.type == "meta" for t in
                   analysis._tensors(got))


class _MeshStandIn:
    """What ``analytic_memory`` reads of a mesh, in both packages."""

    def __init__(self, n):
        self.devices = np.empty((n,), dtype=object)

    def size(self):
        return self.devices.size


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_counts_match_reference(arch):
    import jax
    from repro.configs import registry as rreg
    from repro.launch import dryrun_matrix as rmatrix
    from repro.launch import specs as rspecs
    from repro.roofline import analysis as ranalysis
    rdry = _reference_dryrun()
    cr, ct = rreg.get_config(arch), treg.get_config(arch)
    rparams = jax.eval_shape(lambda: rdry.tr.init_params(
        cr, jax.random.PRNGKey(0)))
    tparams = tspecs.input_specs(ct, "train_4k")["params"]
    n_active = dryrun.active_params(ct, tparams)
    assert n_active == rdry.active_params(cr, rparams)
    assert dryrun.tr.param_count(tparams) == rdry.tr.param_count(rparams)
    for shape in SHAPE_NAMES:
        assert analysis.model_flops(ct, shape, n_params_active=n_active) == \
            ranalysis.model_flops(cr, shape, n_params_active=n_active)
        assert dryrun_matrix.est_cost(arch, shape) == \
            rmatrix.est_cost(arch, shape)
        if not tspecs.supported(ct, shape)[0]:
            continue
        mode = tspecs.mode_of(shape)
        tin = tspecs.input_specs(ct, shape)
        for n in (256, 512):
            want = rdry.analytic_memory(cr, rspecs.input_specs(cr, shape),
                                        _MeshStandIn(n), mode)
            if mode == "train":     # token ids and labels: 8 bytes, not 4
                want["batch_global"] += 4 * sum(
                    tin["batch"][k].numel() for k in ("tokens", "labels")
                    if k in tin["batch"])
            assert dryrun.analytic_memory(ct, tin, _MeshStandIn(n),
                                          mode) == want


def test_counter_counts_collectives_flops_and_memory_by_hand(no_group):
    """A (2, 2) fake mesh: a (4, 8) fp32 local shard gathered over
    "model" (128 operand bytes), a (3, 5) bf16 send over "data" (30
    bytes), a (8, 8) x (8, 16) matmul (2048 FLOPs); then the eager
    ``dist`` calls, whose group comes after their operand."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_group(4):
        mesh = dryrun._mesh_of(SMALL)
        with FakeTensorMode():
            d = DTensor.from_local(torch.empty(4, 8), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            counter = analysis.TraceCounter(mesh)
            with counter:
                counter.track(d)
                full = d.full_tensor()
                y = full @ torch.empty(8, 16)
                s = torch.empty(3, 5, dtype=torch.bfloat16)
                r = torch.empty_like(s)
                peer = dist.get_process_group_ranks(mesh.get_group("data"))[1]
                for q in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, s, peer,
                                   mesh.get_group("data")),
                        dist.P2POp(dist.irecv, r, peer,
                                   mesh.get_group("data"))]):
                    q.wait()
                del y
            # the eager collectives (c10d ops): an all-reduce of 6 floats
            # over "model", an all-gather of 5 over the whole group
            with analysis.TraceCounter(mesh) as eager:
                dist.all_reduce(torch.empty(6), group=mesh.get_group("model"))
                dist.all_gather_into_tensor(torch.empty(20), torch.empty(5))
    assert eager.collectives.bytes_by_op == {"all-reduce": 24,
                                             "all-gather": 20}
    assert eager.collectives.bytes_by_group == {"model": 24, "world": 20}
    coll = counter.collectives
    assert coll.bytes_by_op == {"all-gather": 128, "collective-permute": 30}
    assert coll.count_by_op == {"all-gather": 1, "collective-permute": 1}
    assert coll.bytes_by_group == {"model": 128, "data": 30}
    assert coll.rate_by_group == {"model": hw.NVLINK_BW_PER_DIRECTION,
                                  "data": hw.NVLINK_BW_PER_DIRECTION}
    assert counter.flops == 2 * 8 * 8 * 16
    assert analysis.shape_bytes(torch.bfloat16, (3, 5)) == 30
    # live at the matmul: the shard, the gathered tensor, its operand and
    # the product
    assert counter.peak_bytes == 4 * (4 * 8 + 8 * 8 + 8 * 16 + 8 * 16)
    terms, same = analysis.terms_from_trace(counter, 4)
    assert same is coll and terms.collective_bytes == 158
    assert terms.t_collective == 158 / hw.NVLINK_BW_PER_DIRECTION
    assert set(terms.as_dict()) == ROOFLINE_KEYS


def test_counter_counts_the_split_routes_collectives_by_hand(no_group):
    """A (2, 2) fake mesh: the column product's input (``copy_to_model``:
    nothing forward, its gradient all-reduced over "model" backward), a
    row product's partial sum (``reduce_from_model``: all-reduced forward,
    nothing backward), both from inside autograd Functions; one layer's
    weight fetched with its data dim gathered (an all-gather over "data")
    whose backward reduce-scatters the gradient over "data"; and the
    vocabulary-parallel cross-entropy's three all-reduces (the max and the
    sum of exponentials of 6 rows, the gold logits)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.sharding import tensor_parallel as tpm
    with dryrun.fake_group(4):
        mesh = dryrun._mesh_of(SMALL)
        axis = tpm.GroupAxis(mesh.get_group("model"), 0, 2)
        fetch = tpm._MeshFetch(mesh)
        cfg = treg.get_smoke_config("qwen2-7b").replace(d_ff=16)
        with FakeTensorMode():
            w = DTensor.from_local(torch.empty(3, 4, 8), mesh,
                                   [Shard(1), Shard(2)], run_check=False,
                                   shape=(3, 8, 16), stride=(128, 16, 1))
            w.requires_grad_(True)
            x = torch.empty(5, 8, requires_grad=True)
            tp = tpm.TensorParallel(cfg, axis, fetch)
            with analysis.TraceCounter(mesh) as layer:
                # the leaf's columns are this rank's FFN block: kept local
                y = tpm.copy_to_model(x, axis) @ fetch(tp, ("mlp", "w_up"),
                                                       w, 1)
                out = tpm.reduce_from_model(y @ torch.empty(8, 8), axis)
                torch.autograd.grad(out.sum(), [x, w])
            with analysis.TraceCounter(mesh) as xent:
                tpm.vocab_xent(torch.empty(6, 16), torch.zeros(6).long(), 0,
                               axis)
    coll = layer.collectives
    assert coll.count_by_op == {"all-gather": 1, "all-reduce": 2,
                                "reduce-scatter": 1}
    assert coll.bytes_by_op == {"all-gather": 4 * 4 * 8,
                                "all-reduce": 2 * 4 * 5 * 8,
                                "reduce-scatter": 4 * 8 * 8}
    assert coll.bytes_by_group == {"data": 4 * 4 * 8 + 4 * 8 * 8,
                                   "model": 2 * 4 * 5 * 8}
    assert xent.collectives.count_by_op == {"all-reduce": 3}
    assert xent.collectives.bytes_by_group == {"model": 3 * 4 * 6}


def test_counter_counts_the_split_decode_by_hand(no_group):
    """A (1, 4) fake mesh, rank 0, a cache split on the head dim (2 KV
    heads, D = 32 on 4 ranks: 8 dims a rank) and 10 q heads in blocks of
    3, 3, 2, 2: the decode step's attention sends the queries at the
    other ranks' dims (an all-to-all of 3 heads x 8 dims x 3 ranks), all-
    reduces the scores (10 heads x 40 slots, float32) and sends the
    output back (an all-to-all of 7 heads x 8 dims); the new slot goes to
    the shards from the rank that owns KV head 0 (1 head x 8 dims x 3
    ranks, k and v). Nothing of the cache moves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.layers.attention import KVCache
    from repro_torch.sharding import tensor_parallel as tpm
    with dryrun.fake_group(4):
        mesh = dryrun._mesh_of((1, 4))
        axis = tpm.GroupAxis(mesh.get_group("model"), 0, 4)
        cfg = treg.get_smoke_config("qwen2-7b").replace(
            num_heads=10, num_kv_heads=2, head_dim=32, dtype="float32")
        tp = tpm.TensorParallel(cfg, axis, None)
        assert tp.kv_layout == "dims" and tp.heads.q == (0, 3)
        with FakeTensorMode():
            cache = KVCache(torch.empty(1, 40, 2, 8), torch.empty(1, 40, 2, 8))
            pos = torch.zeros(1, dtype=torch.int32)
            with analysis.TraceCounter(mesh) as step:
                tp.decode_attention(torch.empty(1, 1, 3, 32), cache,
                                    torch.empty(1, 1, 32),
                                    torch.empty(1, 1, 32),
                                    pos.long(), pos + 1, pos, None, 0.1)
    coll = step.collectives
    assert coll.count_by_op == {"all-to-all": 3, "all-reduce": 1}
    assert coll.bytes_by_op == {
        "all-to-all": 4 * (2 * 1 * 8 * 3 + 3 * 8 * 3 + 7 * 8),
        "all-reduce": 4 * 10 * 40}
    assert coll.bytes_by_group == {"model": 4 * (48 + 72 + 56 + 400)}


def test_link_rate_prices_groups_by_node():
    assert analysis.link_rate(range(8)) == hw.NVLINK_BW_PER_DIRECTION
    assert analysis.link_rate(range(16)) == hw.NODE_FABRIC_BW_PER_CARD
    assert analysis.link_rate([0, 256]) == hw.NODE_FABRIC_BW_PER_CARD
    assert hw.NODE_FABRIC_BW_PER_CARD == hw.NODE_FABRIC_BW / 8
    assert (hw.SINGLE_MESH_CARDS, hw.MULTI_MESH_CARDS) == (256, 512)


def _records(out):
    return sorted(os.listdir(out))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_every_arch_traces_under_fake_mode(arch, tmp_path, no_group):
    """Train, prefill and decode of each smoke config at the full shapes
    on a (2, 2) fake mesh: an ``ok`` record with the reference's keys, or
    the reference's skip. An SSD config's chunk is raised to 1,024
    tokens: the plain scan walks its chunks in a Python loop, 1,024 of
    them at the smoke chunk over 32,768 tokens."""
    cfg = treg.get_smoke_config(arch)
    over = ({"ssm": dataclasses.replace(cfg.ssm, chunk_size=1024)}
            if cfg.ssm else {})
    written = []
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_one(arch, shape, False, str(tmp_path),
                             mesh_shape=SMALL, smoke=True,
                             cfg_overrides=over)
        assert rec["chips"] == 4 and rec["mesh"] == "2x2"
        if rec["status"] == "skipped":
            assert not tspecs.supported(treg.get_smoke_config(arch),
                                        shape)[0]
            continue
        written.append(f"torch_{arch}_{shape}_2x2.json")
        assert set(rec) == RECORD_KEYS - (
            set() if cfg.moe is not None else MOE_KEYS)
        assert set(rec["roofline"]) == ROOFLINE_KEYS
        assert rec["status"] == "ok" and rec["scan_counted"] is False
        assert rec["cost_analysis"]["flops"] > 0
        assert rec["memory_analysis"]["fits"] == (
            rec["memory_analysis"]["peak_bytes_per_card"] <= hw.HBM_BYTES)
        assert rec["collectives"]["bytes_by_op"]["all-gather"] > 0
        with open(tmp_path / written[-1]) as f:
            assert json.load(f) == json.loads(json.dumps(rec))
    assert _records(tmp_path) == sorted(written)
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k"])
def test_split_route_divides_the_per_card_flops_over_model(shape, tmp_path,
                                                           no_group):
    """The smoke Qwen2-7B at the full shapes: on a fake (1, 4) mesh its
    heads, FFN columns and vocabulary split four ways, so a card counts at
    most 0.35x the FLOPs of the (1, 1) mesh (the even share is 0.25; each
    rank also computes the KV head its head reads, one of 2), its record
    says ``split`` and the "model" dim carries the all-reduces; the smoke
    Mixtral's says ``split`` too."""
    one = dryrun.run_one("qwen2-7b", shape, False, str(tmp_path / "1"),
                         mesh_shape=(1, 1), smoke=True)
    four = dryrun.run_one("qwen2-7b", shape, False, str(tmp_path / "4"),
                          mesh_shape=(1, 4), smoke=True)
    assert one["model_axis"] == four["model_axis"] == ROUTE_SPLIT
    assert (four["cost_analysis"]["flops"]
            <= 0.35 * one["cost_analysis"]["flops"])
    coll = four["collectives"]
    assert coll["count_by_op"]["all-reduce"] > 0
    assert coll["bytes_by_mesh_dim"]["model"] > 0
    moe = dryrun.run_one("mixtral-8x7b", shape, False, str(tmp_path / "m"),
                         mesh_shape=(1, 4), smoke=True)
    assert moe["model_axis"] == ROUTE_SPLIT


@pytest.mark.parametrize("arch,route", [
    ("mixtral-8x7b", ROUTE_SPLIT), ("deepseek-v3-671b", ROUTE_SPLIT),
    ("mamba2-2.7b", ROUTE_SPLIT), ("zamba2-1.2b", ROUTE_SPLIT)],
    ids=["mixtral-8x7b", "deepseek-v3-671b", "mamba2-2.7b", "zamba2-1.2b"])
def test_each_stack_records_its_route(arch, route, tmp_path, no_group):
    """The smoke config's ``decode_32k`` cell on a fake (2, 2) mesh: the
    record is ``ok`` and names the route its step took, the split one for
    every stack. The MoE stacks' expert products split over "model" (the
    data axes' all-to-all of the kept rows and the "model" all-reduces are
    counted, no reduce-scatter); the Mamba2 stacks' SSD heads split over
    "model" (the out product's and the gated norm's all-reduces, the
    all-to-alls that bring ``w_in``'s ranges and the conv rows)."""
    rec = dryrun.run_one(arch, "decode_32k", False, str(tmp_path),
                         mesh_shape=(2, 2), smoke=True)
    assert rec["status"] == "ok"
    assert rec["model_axis"] == route
    ops = rec["collectives"]["count_by_op"]
    assert ops["all-reduce"] > 0
    assert rec["collectives"]["bytes_by_mesh_dim"]["model"] > 0
    if treg.get_config(arch).moe is not None:
        assert "reduce-scatter" not in ops
        assert "data" in rec["collectives"]["bytes_by_op_and_mesh_dim"][
            "all-to-all"]
    else:
        assert ops["all-to-all"] > 0


def test_run_one_keeps_its_records_in_out_dir(tmp_path, monkeypatch,
                                             no_group):
    """A decode cell on (2, 2, 2), a skipped cell (no record), a train
    cell with ``grad_accum`` 2 (its record named ``_ga2``, apart from one
    at ``grad_accum`` 1; its microbatch's 128 rows split over "data"):
    only their records appear, in ``out_dir``; nothing lands in the
    working directory."""
    out, cwd = tmp_path / "out", tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rec = dryrun.run_one("mixtral-8x7b", "long_500k", True, str(out),
                         mesh_shape=(2, 2, 2), smoke=True)
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert set(rec["collectives"]["bytes_by_mesh_dim"]) <= {"pod", "data",
                                                            "model"}
    skipped = dryrun.run_one("hubert-xlarge", "decode_32k", False, str(out),
                             mesh_shape=SMALL, smoke=True)
    assert skipped["status"] == "skipped" and skipped["reason"]
    rec = dryrun.run_one("qwen2-7b", "train_4k", False, str(out),
                         mesh_shape=SMALL, smoke=True, grad_accum=2)
    assert rec["grad_accum"] == 2 and rec["moment_dtype"] == "float32"
    assert rec["data_split"] == "rows"
    assert _records(out) == ["torch_mixtral-8x7b_long_500k_2x2x2.json",
                             "torch_qwen2-7b_train_4k_2x2_ga2.json"]
    assert _records(cwd) == [] and _records(tmp_path) == ["cwd", "out"]


def test_moe_prefill_sends_each_kept_row_once_over_data(tmp_path, no_group):
    """The smoke Mixtral's ``prefill_32k`` (16 rows of 32,768 tokens a data
    rank) on a fake (2, 2) mesh: no reduce-scatter of dispatch slots over
    "data", and the "data" all-to-all's operand is what rank 0 sends of
    the balanced routing, counted here by hand: each (rank, expert) holds
    Tl k / E consecutive slots (rank 0's first), data rank q computes
    slots [q Cb, (q + 1) Cb) below the capacity C; rank 0 sends its rows
    outside its own block and returns the outputs of the rows that reach
    it, d bf16 values a row, at each of its 2 experts and 2 layers. The
    record's ``moe_forward`` counts the 2 MoE layers' forward calls, a
    part of the step's FLOPs."""
    rec = dryrun.run_one("mixtral-8x7b", "prefill_32k", False, str(tmp_path),
                         mesh_shape=(2, 2), smoke=True)
    assert rec["moe_dispatch_sizes"] == "balanced"
    share = rec["moe_forward"]
    assert share["calls"] == 2
    assert 0 < share["flops"] < rec["cost_analysis"]["flops"]
    by = rec["collectives"]["bytes_by_op_and_mesh_dim"]
    assert "data" not in by.get("reduce-scatter", {})
    cfg = treg.get_smoke_config("mixtral-8x7b")
    S, B = tspecs.SHAPES["prefill_32k"]
    n, E, k = 2, cfg.moe.num_experts, cfg.moe.top_k
    tl = B // n * S
    share = tl * k // E                       # a (rank, expert)'s rows
    C = -(-math.ceil(n * tl * k / E * cfg.moe.capacity_factor) // 8) * 8
    Cb = -(-C // n)
    mine = (0, min(share, Cb))               # rank 0's rows in block 0
    sent = share - (mine[1] - mine[0])
    got = sum(max(0, min((r + 1) * share, Cb, C) - max(r * share, 0))
              for r in range(1, n))
    rows = (sent + got) * (E // 2) * cfg.num_layers
    assert by["all-to-all"]["data"] == rows * cfg.d_model * 2
    assert rows > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_long_decode_moves_no_cache_leaf_over_data(arch, tmp_path,
                                                   no_group):
    """The smoke config's ``long_500k`` decode (B = 1, 524,288 slots) on
    a fake (2, 2) mesh: the row does not divide "data", so the cache's
    slots lie in halves over it (``cache_specs``) and stay there. Every
    byte the step moves over "data" together is less than one layer's KV
    or latent leaf on a rank (the partial softmaxes and a layer's
    parameters move, never the cache); the record says ``sequence``."""
    rec = dryrun.run_one(arch, "long_500k", False, str(tmp_path),
                         mesh_shape=(2, 2), smoke=True)
    assert rec["status"] == "ok" and rec["data_split"] == "sequence"
    cfg = treg.get_smoke_config(arch)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    slots = tspecs.SHAPES["long_500k"][0] // 2
    # a rank's half of ckv's dims, or of a KV leaf's heads (or dims)
    width = (cfg.mla.kv_lora_rank if cfg.attention == "mla"
             else cfg.num_kv_heads * cfg.head_dim) // 2
    leaf = slots * width * itemsize
    data = rec["collectives"]["bytes_by_mesh_dim"]["data"]
    assert 0 < data < leaf


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_only_long_500k_and_split_serves_split_the_sequence(shape):
    """On the production meshes' data axes (16 on a pod, 32 on two) every
    shape's batch divides them but ``long_500k``'s one row, whose 524,288
    positions split instead; a split serve's microbatch (32 rows in 8, on
    a pod's "data" = 16) splits its 4,096 positions. So of the 66 records
    only the 8 ``long_500k`` ones and the 8 split serves change layout."""
    from repro_torch.sharding.context_parallel import data_split
    S, B = tspecs.SHAPES[shape]
    want = "sequence" if shape == "long_500k" else "rows"
    assert [data_split(B, S, n) for n in (16, 32)] == [want, want]
    assert data_split(32 // 8, 4096, 16) == "sequence"


def test_a_batch_that_divides_keeps_its_rows(tmp_path, no_group):
    """``decode_32k`` (128 rows) on the fake (2, 2) mesh splits its rows
    over "data" as before; a split serve's microbatch of 2 rows on 2 data
    ranks too, of 1 row its sequence."""
    rec = dryrun.run_one("qwen2-7b", "decode_32k", False, str(tmp_path),
                         mesh_shape=(2, 2), smoke=True)
    assert rec["data_split"] == "rows"
    for batch, split in ((8, "rows"), (4, "sequence")):
        rec = dryrun.run_split_serve("qwen2-7b", str(tmp_path),
                                     num_microbatches=4, seq_len=64,
                                     batch=batch, mesh_shape=(2, 2, 2),
                                     smoke=True)
        assert rec["data_split"] == split


def test_run_one_refuses_a_group_of_another_size(no_group):
    with dryrun.fake_group(2):
        with pytest.raises(RuntimeError, match="needs 4"):
            dryrun.run_one("qwen2-7b", "decode_32k", False, "/nonexistent",
                           mesh_shape=SMALL, smoke=True)


@pytest.mark.parametrize("batch", (8, 4))
def test_run_split_serve_counts_the_hop(batch, tmp_path, no_group):
    """Smoke Qwen2-7B on a (2, 2, 2) fake mesh, ``batch`` rows of 64
    tokens in 4 microbatches: each stage on the split route, so rank 0
    (pod 0) sends each of the 5 ticks its (data, model) block of the
    activation, 1/4 of the microbatch's (batch / 4) x 64 x d (8 rows: a
    microbatch's 2 rows split over "data", d over "model"; 4 rows: the
    row whole, S over "data", d over "model"), and no angles; the last
    pod's result reaches every pod as one float32 all-reduce over "pod"
    of each rank's block, 1/4 of the whole result."""
    cfg = treg.get_smoke_config("qwen2-7b")
    rec = dryrun.run_split_serve("qwen2-7b", str(tmp_path),
                                 num_microbatches=4, seq_len=64,
                                 batch=batch, mesh_shape=(2, 2, 2),
                                 smoke=True)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    per_tick = batch // 4 * 64 * cfg.d_model // 4 * itemsize
    coll = rec["collectives"]
    assert rec["model_axis"] == "split"
    assert coll["bytes_by_op"]["collective-permute"] == 5 * per_tick
    assert coll["count_by_op"]["collective-permute"] == 5
    assert rec["hop"] == {"ticks": 5,
                          "collective_permute_bytes_per_card": 5 * per_tick,
                          "activation_shards_in_reference": 4}
    assert coll["bytes_by_op_and_mesh_dim"]["all-reduce"]["pod"] == \
        batch * 64 * cfg.d_model * 4 // 4
    assert rec["boundary_bytes_model"] == batch * 64 * cfg.d_model * 2
    assert set(rec["eq5_prediction"]) == {"T", "T_D", "T_TX", "T_S"}
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert _records(tmp_path) == [
        "torch_qwen2-7b_split_serve_2x2x2.json"]


def test_run_split_serve_splits_the_stage_over_model(tmp_path, no_group):
    """The same serve on (2, 2, 2) and (2, 2, 1): rank 0's stage splits
    over "model", so it computes at most 0.6 of the FLOPs it computes
    where "model" has one rank."""
    recs = [dryrun.run_split_serve("qwen2-7b", str(tmp_path),
                                   num_microbatches=4, seq_len=64, batch=8,
                                   mesh_shape=shape, smoke=True)
            for shape in ((2, 2, 2), (2, 2, 1))]
    split, whole = (r["cost_analysis"]["flops"] for r in recs)
    assert split <= 0.6 * whole
    assert recs[0]["collectives"]["bytes_by_mesh_dim"]["model"] > 0


def test_main_traces_a_full_size_cell_on_the_production_mesh(tmp_path,
                                                             no_group):
    """``main`` on full Qwen2-7B decode_32k over 256 fake ranks."""
    dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh",
                 "pod", "--out", str(tmp_path)])
    with open(tmp_path / "torch_qwen2-7b_decode_32k_pod.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["chips"] == hw.SINGLE_MESH_CARDS
    assert rec["params_total"] == dryrun.tr.param_count(
        tspecs.input_specs(treg.get_config("qwen2-7b"),
                           "decode_32k")["params"])
    # the cache stays where it lies (4 KV heads on 16 ranks: split on the
    # head dim): the queries, the scores and the outputs cross "model"
    # every step, fewer bytes than a card's cache
    coll = rec["collectives"]
    assert 0 < coll["bytes_by_mesh_dim"]["model"] < \
        rec["analytic_memory"]["cache_per_device"]
    assert coll["count_by_op"]["all-to-all"] > 0
    assert rec["collectives"]["link_bytes_per_s_by_mesh_dim"]["model"] == \
        hw.NODE_FABRIC_BW_PER_CARD


def test_matrix_queues_the_cells_without_an_ok_record(tmp_path):
    cells = dryrun_matrix.todo(["pod"], str(tmp_path))
    assert len(cells) == 33
    assert [c[0] for c in cells] == sorted(c[0] for c in cells)
    both = dryrun_matrix.todo(["pod", "multipod"], str(tmp_path))
    assert [c[3] for c in both] == ["pod"] * 33 + ["multipod"] * 33
    _, arch, shape, _ = cells[0]
    with open(tmp_path / f"torch_{arch}_{shape}_pod.json", "w") as f:
        json.dump({"status": "ok"}, f)
    with open(tmp_path / f"torch_{cells[1][1]}_{cells[1][2]}_pod.json",
              "w") as f:
        json.dump({"status": "skipped"}, f)
    assert dryrun_matrix.todo(["pod"], str(tmp_path)) == cells[1:]


def test_fake_mode_repairs_leave_real_runs_alone():
    """``init_params`` under a fake mode reads no data pointer, and
    M-RoPE band ids made under one are not handed to a later real run."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.models import transformer as ttr
    from repro_torch.models.layers import rope
    cfg = treg.get_smoke_config("qwen2-vl-7b")
    pos = torch.arange(12, dtype=torch.int32).reshape(3, 1, 4)
    want = rope.mrope_angles(pos, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    rope._cached_ids.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with FakeTensorMode():
            ttr.init_params(cfg, device="cpu")
            fake = rope.mrope_angles(torch.empty(3, 1, 4, dtype=torch.int32),
                                     cfg.head_dim, cfg.rope_theta,
                                     cfg.mrope_sections)
    assert isinstance(fake, FakeTensor)
    got = rope.mrope_angles(pos, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    assert not isinstance(got, FakeTensor) and torch.equal(got, want)


@pytest.mark.parametrize("window", (None, 6))
def test_plain_gqa_chunks_above_naive_attn_max_as_the_reference(window):
    """``backend="ref"`` is the reference's kernel-off path: above
    ``naive_attn_max`` tokens (8 here; 20 tokens, blocks of 1,024, one
    padded) both run ``chunked_attention``, which the dry run traces at
    32,768 tokens; within 64 eps of the largest output."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as rreg
    from repro.models.layers import attention as ratt
    from repro_torch.interop import transformer_params_from_reference
    from repro_torch.models.layers import attention as tatt
    from torch_parity import stack_tol, transformer_params_np
    over = dict(dtype="float32", naive_attn_max=8, sliding_window=window)
    cr = rreg.get_smoke_config("qwen2-7b").replace(**over)
    ct = treg.get_smoke_config("qwen2-7b").replace(**over)
    pn = transformer_params_np(cr)
    attn_np = jax.tree_util.tree_map(lambda a: a[0], pn["runs"][0]["attn"])
    x = np.random.default_rng(4).standard_normal(
        (2, 20, cr.d_model)).astype(np.float32)
    want, (wk, _) = ratt.gqa_forward(
        jax.tree_util.tree_map(jnp.asarray, attn_np), cr, jnp.asarray(x),
        None)
    want = np.asarray(want)
    got, (gk, _) = tatt.gqa_forward(
        transformer_params_from_reference(attn_np), ct, torch.from_numpy(x),
        None, backend="ref")
    assert np.abs(got.numpy() - want).max() <= stack_tol(want, "float32")
    assert np.abs(gk.numpy() - np.asarray(wk)).max() <= stack_tol(
        np.asarray(wk), "float32")


def test_counter_prices_a_device_read_at_no_bytes(no_group):
    """``prim.device``, the metadata read of a tensor's device, moves no
    byte: ``torch.as_tensor`` of a (1024, 1024) fp32 fake DTensor's shard
    (a step's ``as_tensor`` of its inputs makes the read) and of the
    DTensor itself add 0 bytes under ``TraceCounter``, where the shard's
    read once counted 3 x its 4 MiB. An elementwise op on the same shard
    still counts its operand and its result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_group(4):
        mesh = dryrun._mesh_of(SMALL)
        with FakeTensorMode():
            d = DTensor.from_local(torch.empty(1024, 1024), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            with analysis.TraceCounter(mesh) as read:
                torch.as_tensor(d.to_local())
                torch.as_tensor(d)
            with analysis.TraceCounter(mesh) as scaled:
                d.to_local() * 2
    assert read.bytes_accessed == 0
    assert scaled.bytes_accessed == 2 * 4 * 1024 * 1024


def test_a_microbatch_lies_over_the_data_axes_as_its_rows_do(
        tmp_path, monkeypatch, no_group):
    """``train_4k`` cut to 4 rows of 64 tokens, the smoke Qwen2-7B on a
    fake (2, 2) mesh: in one step the 4 rows split over "data"; in 4
    microbatches each microbatch's one row does not, so its 64 positions
    do (``data_split`` "sequence": each data rank every row's block of
    32, K and V all-gathered over "data"), the record written beside the
    first as ``_ga4``. Rank 0's block attends only its own 32 keys, so
    its FLOPs fall below the row split's."""
    monkeypatch.setitem(tspecs.SHAPES, "train_4k", (64, 4))
    one = dryrun.run_one("qwen2-7b", "train_4k", False, str(tmp_path),
                         mesh_shape=SMALL, smoke=True)
    four = dryrun.run_one("qwen2-7b", "train_4k", False, str(tmp_path),
                          mesh_shape=SMALL, smoke=True, grad_accum=4)
    assert one["status"] == four["status"] == "ok"
    assert (one["data_split"], four["data_split"]) == ("rows", "sequence")
    assert _records(tmp_path) == ["torch_qwen2-7b_train_4k_2x2.json",
                                  "torch_qwen2-7b_train_4k_2x2_ga4.json"]
    assert four["cost_analysis"]["flops"] < one["cost_analysis"]["flops"]
