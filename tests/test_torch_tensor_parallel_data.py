"""The mesh steps over the data axes that split a batch's positions or
its microbatches (``repro_torch.launch.steps``' mesh steps,
``sharding.context_parallel``) against the port's one-process steps and
the reference's unsharded ``prefill``, ``decode_step``,
``jax.value_and_grad`` of ``loss_fn`` and ``make_train_step``, on the same
numpy arrays (``torch_mesh_steps.case_inputs``); the cases' configs are
``test_torch_tensor_parallel.py``'s (``torch_mesh_steps.CASES``).

One spawn of four gloo ranks (``torch_ranks.spawn``: a deadline of its
own; inputs and results through files in ``tmp_path``) on the (2, 2)
("data", "model") mesh runs: the sequence split over "data" (context
parallelism): a B = 1 prefill and 4 decode steps of the smoke Qwen2-7B,
Mixtral-8x7B, DeepSeek-V3, Mamba2-2.7B and Zamba2-1.2B (each data rank
its block of the 16 positions and of the cache's 20 slots), within
``stack_tol`` of the one-process steps and of the reference's jitted
``prefill`` / ``decode_step``, and 2 AdamW steps of the same batch (each
data rank its block of the positions) held to the one-process steps and
to the reference's ``jax.value_and_grad`` and ``make_train_step``; the
same train steps for DeepSeek-V3 at ``grad_accum`` 2 (each microbatch of
1 row a sequence split) and for Qwen2-7B on 15 positions (a batch
neither split divides, whole on both data ranks); the serving steps at a
cache of 21 slots, which the data ranks do not divide (every rank holds
each leaf whole, as ``cache_specs`` lays it out), for Qwen2-7B, a
Mixtral whose window of 24 lies between the 16 positions and twice the
21 slots, DeepSeek-V3 and Zamba2-1.2B; a ``grad_accum`` = 2 train step
(B = 4) of the 2-expert top-1 Mixtral whose whole-batch capacity binds
and of the smoke Mamba2 (row 0 keeping 2 of 8 labels), each microbatch
the reference's rows split over "data"; and, on a (2, 2, 1) ("pod",
"data", "model") mesh, ``DataAxes.all_to_all_rows`` of ragged rows over
both data axes.

This file imports no JAX at module level: the spawned ranks import it by
name."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.sharding.tensor_parallel import ROUTE_SPLIT
from torch_mesh_steps import (DECODE, EPS, EPS32, FAULT_CASE, LR,
                              PARAM_ULPS, UPDATE_RTOL, S, case_inputs, close,
                              hold_to_one_process, leaves, port_config,
                              reference_cache_leaves, stack_tol32,
                              train_steps, whole)
from torch_ranks import init_group, spawn

#: the Mamba2 case run with microbatches on (2, 2), its rows' shares of
#: the labels uneven (the fault of microbatches cut from a rank's rows)
SSM_FAULT_CASE = "mamba2-2.7b"
ACCUM_CASES = (FAULT_CASE, SSM_FAULT_CASE)
#: the cases served on a sequence split over the (2, 2) mesh's "data":
#: B = 1 row of ``CP_S`` positions
CP_CASES = ("qwen2-7b", "mixtral-8x7b", "deepseek-v3-671b", "mamba2-2.7b",
            "zamba2-1.2b")
CP_S = 16
#: the cases served on a sequence split at ``CP_S + DECODE + 1`` slots,
#: which 2 data ranks do not divide, with their config overrides: the
#: Mixtral's window between ``CP_S`` and twice the slots
CP_WHOLE = {"qwen2-7b": {}, "mixtral-8x7b": {"sliding_window": 24},
            "deepseek-v3-671b": {}, "zamba2-1.2b": {}}
#: the train step's other splits over the (2, 2) mesh's "data", by key:
#: (case, rows, positions, grad_accum). "cp_accum": 2 rows in 2
#: microbatches, each of 1 row, so each a sequence split; "cp_whole": 1
#: row of an odd count of positions, which neither split divides, so
#: every data rank holds it whole
CP_TRAIN = {"cp_accum": ("deepseek-v3-671b", 2, CP_S, 2),
            "cp_whole": ("qwen2-7b", 1, CP_S - 1, 1)}
#: (case, slots) of every sequence split run against the reference
CP_RUNS = ([(n, CP_S + DECODE) for n in CP_CASES]
           + [(n, CP_S + DECODE + 1) for n in CP_WHOLE])
#: the fault's case with microbatches: ``ACCUM`` of the rows of a batch of
#: ``ACCUM_B`` (each microbatch split over the (2, 2) mesh's data ranks)
ACCUM, ACCUM_B = 2, 4
#: every case this file runs
NAMES = list(dict.fromkeys(ACCUM_CASES + CP_CASES + tuple(CP_WHOLE)))
#: ``DataAxes.all_to_all_rows`` on the (2, 2, 1) mesh: rows rank r sends
#: rank q (ranks pod major), zero-sized parts among them
RAGGED = [[2, 0, 3, 1], [0, 0, 0, 0], [1, 4, 0, 2], [0, 2, 5, 1]]
#: seconds the four ranks may take (about 60 alone)
DEADLINE = 600


def _sequence_steps(cfg, params, batch, tokens, mesh=None,
                    max_len: int = CP_S + DECODE,
                    train: bool = True) -> dict:
    """A prefill (the cache at ``max_len`` slots) and ``DECODE`` decode
    steps of a batch whose one row does not divide the mesh's data axes
    (on ``mesh``: the sequence split), every tensor whole; with ``train``,
    also 2 AdamW steps of the batch (``train``)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import specs as sh
    p = params
    if mesh is not None:
        p = sh.distribute(params, sh.param_specs(params, cfg, mesh), mesh)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, max_len=max_len,
                                          device="cpu", mesh=mesh)(p, inputs)
        out = {"prefill": whole(logits),
               "cache": [whole(t) for t in leaves(cache["runs"])],
               "decode": []}
        decode = make_decode_step(cfg, device="cpu", mesh=mesh)
        for t in tokens:
            logits, cache = decode(p, cache, t)
            out["decode"].append(whole(logits))
        out["cache_after"] = [whole(t) for t in leaves(cache["runs"])]
    if train:
        out["train"] = train_steps(cfg, params, None, batch, mesh)
    return out


def _rank(rank: int, port: int, d: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)        # four ranks beside the other workers
    init_group(rank, 4, port)
    try:
        # the faults' cases with microbatches: the (2, 2) mesh's
        # microbatch must be the reference's rows, not every rank's i-th
        # chunk
        for name in ACCUM_CASES:
            inp = torch.load(os.path.join(d, f"{name}.in.pt"))
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            got = train_steps(port_config(name), inp["params"],
                              inp["masks"], inp["accum_batch"], mesh,
                              steps=1, grad_accum=ACCUM)
            if rank == 0:
                torch.save(got, os.path.join(d, f"{name}.accum.pt"))
        # B = 1: the sequence split over "data"
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for name in CP_CASES:
            inp = torch.load(os.path.join(d, f"{name}.in.pt"))
            got = _sequence_steps(port_config(name), inp["params"],
                                  inp["cp_batch"], inp["cp_tokens"], mesh)
            if rank == 0:
                torch.save(got, os.path.join(d, f"{name}.cp.pt"))
        for name, over in CP_WHOLE.items():
            inp = torch.load(os.path.join(d, f"{name}.in.pt"))
            got = _sequence_steps(port_config(name).replace(**over),
                                  inp["params"], inp["cp_batch"],
                                  inp["cp_tokens"], mesh,
                                  max_len=CP_S + DECODE + 1, train=False)
            if rank == 0:
                torch.save(got, os.path.join(d, f"{name}.cpw.pt"))
        for key, (name, _, _, accum) in CP_TRAIN.items():
            inp = torch.load(os.path.join(d, f"{name}.in.pt"))
            got = train_steps(port_config(name), inp["params"], None,
                              inp[key], mesh, grad_accum=accum)
            if rank == 0:
                torch.save(got, os.path.join(d, f"{name}.{key}.pt"))
        mesh = init_device_mesh("cpu", (2, 2, 1),
                                mesh_dim_names=("pod", "data", "model"))
        got = _ragged_rows(mesh)
        if rank == 0:
            torch.save(got, os.path.join(d, "ragged.pt"))
    finally:
        dist.destroy_process_group()


def _ragged_rows(mesh) -> list:
    """Every rank's ``DataAxes.all_to_all_rows`` of its ``RAGGED`` rows on
    ``mesh``'s "pod" and "data" (row i to rank q of rank r is [r, q, i]),
    gathered to each rank."""
    import torch.distributed as dist
    from repro_torch.sharding.tensor_parallel import data_axes
    data = data_axes(mesh)
    me = data.rank
    x = torch.tensor([[me, q, i] for q in range(4)
                      for i in range(RAGGED[me][q])],
                     dtype=torch.float32).reshape(-1, 3)
    mine = data.all_to_all_rows(x, RAGGED)
    got = [None] * 4
    dist.all_gather_object(got, (me, mine))
    return got


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's smoke-size work (its ranks run
    beside the other workers), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"numpy": the shared arrays, "cp_one" and the train keys'
    one-process runs, and the spawn's "accum" / "cp" / "cpw" / train
    keys' runs}, "ragged": each rank's rows}: the inputs made here from
    numpy, the ranks spawned once for every case."""
    from torch_parity import free_port, train_batch_np
    d = str(tmp_path_factory.mktemp("tp_data"))
    out = {}
    for name in NAMES:
        (cr, *rest), inp = case_inputs(name)
        tok = rest[-1]
        out[name] = {"numpy": (cr, *rest)}
        if name in ACCUM_CASES:
            acc = train_batch_np(cr, ACCUM_B, S, seed=8)
            if name == SSM_FAULT_CASE:
                # row 0 keeps 2 labels of 8: the rows' shares differ
                acc["labels"][0, 2:] = -1
            inp["accum_batch"] = {k: torch.from_numpy(np.asarray(v))
                                  for k, v in acc.items()}
            out[name]["accum_batch"] = acc
        if name in CP_CASES:
            cp_bn = train_batch_np(cr, 1, CP_S, seed=7)
            inp["cp_batch"] = {k: torch.from_numpy(np.asarray(v))
                               for k, v in cp_bn.items()}
            inp["cp_tokens"] = [torch.from_numpy(t[:1].astype(np.int64))
                                for t in tok]
            cp = out[name]
            cp["cp_numpy"] = (cp_bn, tok[:, :1])
            cp["cp_one"] = _sequence_steps(
                port_config(name), inp["params"], inp["cp_batch"],
                inp["cp_tokens"])
            for key, (_, rows, positions, accum) in (
                    (k, v) for k, v in CP_TRAIN.items() if v[0] == name):
                bn_k = train_batch_np(cr, rows, positions, seed=9)
                inp[key] = {k: torch.from_numpy(np.asarray(v))
                            for k, v in bn_k.items()}
                cp[key + "_numpy"] = bn_k
                cp[key + "_one"] = train_steps(
                    port_config(name), inp["params"], None, inp[key],
                    grad_accum=accum)
            if name in CP_WHOLE:
                cp["cpw_one"] = _sequence_steps(
                    port_config(name).replace(**CP_WHOLE[name]),
                    inp["params"], inp["cp_batch"], inp["cp_tokens"],
                    max_len=CP_S + DECODE + 1, train=False)
        torch.save(inp, os.path.join(d, f"{name}.in.pt"))
    spawn(_rank, (free_port(), d), 4, DEADLINE)
    for name in ACCUM_CASES:
        out[name]["accum"] = torch.load(os.path.join(d, f"{name}.accum.pt"))
    for name in CP_CASES:
        out[name]["cp"] = torch.load(os.path.join(d, f"{name}.cp.pt"))
    for name in CP_WHOLE:
        out[name]["cpw"] = torch.load(os.path.join(d, f"{name}.cpw.pt"))
    for key, (name, *_) in CP_TRAIN.items():
        out[name][key] = torch.load(os.path.join(d, f"{name}.{key}.pt"))
    out["ragged"] = torch.load(os.path.join(d, "ragged.pt"))
    return out


def _check_sequence_steps(got, want) -> None:
    """The prefill's logits and cache and the decode steps' logits and
    cache of ``_sequence_steps`` within ``stack_tol`` of ``want``'s."""
    close(got["prefill"], want["prefill"], stack_tol32)
    assert len(got["decode"]) == len(want["decode"]) == DECODE
    for key in ("cache", "cache_after"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            close(g, w, stack_tol32)
    for g, w in zip(got["decode"], want["decode"]):
        close(g, w, stack_tol32)


@pytest.mark.parametrize("name", CP_CASES)
def test_mesh_sequence_split_matches_one_process(name, runs):
    """B = 1 on the (2, 2) mesh: the row does not divide "data", so each
    data rank prefills its block of the 16 positions and holds its block
    of the cache's 20 slots (``cache_specs``); the prefill's logits and
    cache and 4 decode steps' logits and cache within ``stack_tol`` of the
    one-process steps."""
    _check_sequence_steps(runs[name]["cp"], runs[name]["cp_one"])


@pytest.mark.parametrize("name", list(CP_WHOLE))
def test_mesh_sequence_split_keeps_slots_it_does_not_divide_whole(name,
                                                                  runs):
    """B = 1 on the (2, 2) mesh at a cache of 21 slots, which the 2 data
    ranks do not divide: each data rank prefills its block of the 16
    positions but holds every leaf's 21 slots whole (``cache_specs``),
    placed so (each leaf gathers to 21 slots, not 42) and read so by the
    decode steps (every rank writes the slot and attends all of them; the
    Mixtral's window of 24 against its 21 rolling slots, not against 42):
    within ``stack_tol`` of the one-process steps."""
    _check_sequence_steps(runs[name]["cpw"], runs[name]["cpw_one"])


def _reference_adamw(cr, pn, bn, grad_accum: int, steps: int = 2):
    """The reference's ``make_train_step`` with AdamW (``LR``, eps
    ``EPS``) for ``steps`` steps of ``bn``: each step's metrics, and the
    parameters after them as numpy leaves in its tree's order."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as rsteps
    from repro.optim import adamw as radamw
    from repro.optim import constant as rconstant
    from torch_parity import to_f32
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    opt = radamw(rconstant(LR), eps=EPS)
    step = rsteps.make_train_step(cr, opt, None, grad_accum)
    p, metrics = j(pn), []
    state = opt.init(p)
    for _ in range(steps):
        p, state, m = step(p, state, j(bn))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [to_f32(a) for a in jax.tree_util.tree_leaves(p)]


def _check_sequence_train(got, one, cr, pn, bn, grad_accum: int) -> None:
    """The mesh's 2 AdamW steps of ``bn`` (``train``, ``grad_accum``
    microbatches) held to the one-process steps (``hold_to_one_process``)
    and to the reference: the first step's loss within ``LOSS_RTOL32``
    and gradient within ``GRAD_RTOL32`` of ``jax.value_and_grad`` of its
    ``loss_fn`` (over its microbatches), each step's loss within
    ``LOSS_RTOL32`` of its ``make_train_step``'s and the parameters after
    the 2 steps within the one-process tolerance of its."""
    from repro_torch.interop import transformer_params_from_reference
    from repro_torch.optim.optimizers import tree_map
    from torch_parity import (LOSS_RTOL32, assert_grads_close32,
                              port_grad_leaves)
    assert got["route"] == ROUTE_SPLIT
    hold_to_one_process(got, one)
    rows = np.asarray(bn["labels"]).shape[0]
    first, grads = _reference_microbatches(
        cr, pn, None, bn, np.array_split(np.arange(rows), grad_accum))
    assert abs(got["metrics"][0]["loss"] - first["loss"]) <= \
        LOSS_RTOL32 * abs(first["loss"])
    like = transformer_params_from_reference(pn)

    def as_reference(flat):
        flat = iter(flat)
        return port_grad_leaves(tree_map(lambda _: next(flat), like))
    assert_grads_close32(as_reference(got["grads"]), grads)
    metrics, params = _reference_adamw(cr, pn, bn, grad_accum)
    for gm, wm in zip(got["metrics"], metrics):
        assert abs(gm["loss"] - wm["loss"]) <= LOSS_RTOL32 * abs(wm["loss"])
    for g, w in zip(as_reference(got["params"]), params):
        tol = PARAM_ULPS * EPS32 * float(np.abs(w).max()) + UPDATE_RTOL * LR
        close(g, w, lambda _: tol)


@pytest.mark.parametrize("name", CP_CASES)
def test_mesh_train_step_refuses_a_sequence_split(name, runs):
    """(Named for the refusal it held until the train step took a
    sequence split.) B = 1 on the (2, 2) mesh: the row does not divide
    "data", so each data rank trains its block of the 16 positions (K and
    V, MLA's latents, the conv's halo and the SSD state exchanged, each
    exchange's gradient sent back) weighted by its share of the labels;
    2 AdamW steps held by ``_check_sequence_train`` to the one-process
    steps and to the reference's."""
    cr, pn = runs[name]["numpy"][:2]
    _check_sequence_train(runs[name]["cp"]["train"],
                          runs[name]["cp_one"]["train"], cr, pn,
                          runs[name]["cp_numpy"][0], 1)


@pytest.mark.parametrize("key", list(CP_TRAIN))
def test_mesh_train_step_takes_sequence_microbatches_and_whole_batches(
        key, runs):
    """On the (2, 2) mesh: DeepSeek-V3's 2 rows in ``grad_accum`` = 2
    microbatches of 1 row, each microbatch a sequence split of its own
    (its MoE dispatch, router and MTP losses the microbatch's); and
    Qwen2-7B's one row of 15 positions, which neither the rows nor the
    positions split, held whole on both data ranks, each rank's loss
    weighted 1/2. 2 AdamW steps each, held by ``_check_sequence_train``."""
    name, *_, accum = CP_TRAIN[key]
    cr, pn = runs[name]["numpy"][:2]
    _check_sequence_train(runs[name][key], runs[name][key + "_one"], cr, pn,
                          runs[name][key + "_numpy"], accum)


def _reference_sequence_serve(cr, bn, tok, pn, max_len):
    """The reference's jitted prefill (the cache at ``max_len`` slots)
    and decode steps on one row: its logits and cache leaves as
    ``_sequence_steps`` gives them."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as rtr
    from torch_parity import to_f32
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    prefill = jax.jit(lambda p, b: rtr.prefill(p, cr, b, max_len=max_len))
    decode = jax.jit(lambda p, c, t: rtr.decode_step(p, cr, c, t))
    inputs = {k: v for k, v in bn.items() if k != "labels"}
    logits, cache = prefill(j(pn), j(inputs))
    out = {"prefill": to_f32(logits),
           "cache": reference_cache_leaves(cr, cache), "decode": []}
    for t in tok:
        logits, cache = decode(j(pn), cache, jnp.asarray(t, jnp.int32))
        out["decode"].append(to_f32(logits))
    out["cache_after"] = reference_cache_leaves(cr, cache)
    return out


@pytest.mark.parametrize("name,slots", CP_RUNS,
                         ids=[f"{n}-{k}" for n, k in CP_RUNS])
def test_mesh_sequence_split_matches_reference(name, slots, runs):
    """The sequence split's mesh run on the (2, 2) mesh (a cache of 20
    slots, split over "data", or of 21, whole on every data rank): the
    prefill's logits and cache and 4 decode steps' logits and cache within
    ``stack_tol`` of the reference's unsharded ``prefill`` and
    ``decode_step`` on the same row and tokens."""
    cr, pn = runs[name]["numpy"][:2]
    whole = slots != CP_S + DECODE
    if whole:
        cr = cr.replace(**CP_WHOLE[name])
    want = _reference_sequence_serve(cr, *runs[name]["cp_numpy"], pn,
                                     slots)
    _check_sequence_steps(runs[name]["cpw" if whole else "cp"], want)


def _reference_microbatches(cr, pn, mn, bn, rows):
    """The reference's train step in microbatches of ``rows`` (lists of
    row indices of ``bn``): each microbatch's ``jax.value_and_grad`` of
    ``loss_fn``, the metrics averaged and the gradients summed in fp32 and
    divided, as its ``make_train_step`` does with ``grad_accum``."""
    from torch_parity import reference_loss_and_grads
    parts = [reference_loss_and_grads(
        cr, pn, {k: np.asarray(v)[r] for k, v in bn.items()}, mn)
        for r in rows]
    metrics = {k: float(np.mean([m[k] for _, m, _ in parts]))
               for k in parts[0][1]}
    metrics["loss"] = float(np.mean([loss for loss, _, _ in parts]))
    grads = [sum(np.asarray(g[i], np.float32) for _, _, g in parts)
             / len(parts) for i in range(len(parts[0][2]))]
    return metrics, grads


def test_moe_microbatches_are_the_reference_rows_on_the_data_axes(runs):
    """The fault's case with ``grad_accum`` = 2 on the (2, 2) mesh: the
    mesh's microbatch i is the reference's contiguous chunk i of the whole
    batch, each split over the data ranks, not the union of every data
    rank's i-th chunk of its own rows (rows {0, 2} and {1, 3} of 4, whose
    capacities, drops and balance losses differ on these inputs). The
    loss, ``moe_aux``, ``moe_z`` and the gradient match the reference's
    step in microbatches within ``LOSS_RTOL32`` / ``GRAD_RTOL32``."""
    from repro_torch.interop import transformer_params_from_reference
    from repro_torch.optim.optimizers import tree_map
    from torch_parity import (LOSS_RTOL32, assert_grads_close32,
                              port_grad_leaves)
    cr, pn, mn = runs[FAULT_CASE]["numpy"][:3]
    bn, got = runs[FAULT_CASE]["accum_batch"], runs[FAULT_CASE]["accum"]
    n = ACCUM_B // ACCUM
    want, grads = _reference_microbatches(
        cr, pn, mn, bn, [list(range(i * n, (i + 1) * n))
                         for i in range(ACCUM)])
    # a microbatch a data rank's i-th chunk of its own rows would make
    per = ACCUM_B // 2
    apart, _ = _reference_microbatches(
        cr, pn, mn, bn, [[r * per + i for r in range(2)]
                         for i in range(ACCUM)])
    assert any(abs(apart[k] - want[k]) > LOSS_RTOL32 * abs(want[k])
               for k in ("loss", "moe_aux"))
    assert got["route"] == ROUTE_SPLIT
    for k in ("loss", "moe_aux", "moe_z"):
        assert abs(got["metrics"][0][k] - want[k]) <= \
            LOSS_RTOL32 * abs(want[k])
    flat = iter(got["grads"])
    tree = tree_map(lambda _: next(flat),
                    transformer_params_from_reference(pn))
    assert_grads_close32(port_grad_leaves(tree), grads)


def test_ssm_microbatches_are_the_reference_rows_on_the_data_axes(runs):
    """The smoke Mamba2 with ``grad_accum`` = 2 on the (2, 2) mesh (B = 4,
    row 0 keeping 2 of its 8 labels): microbatch i is the reference's
    contiguous chunk i of the whole batch, each split over the data ranks.
    The mesh steps that took each rank's rows first and cut those into
    microbatches ran rows {0, 2} and {1, 3}, and with the rows' shares of
    the labels uneven each microbatch's mean differs. The loss, ``xent``
    and every gradient leaf match ``jax.value_and_grad`` of the
    reference's ``loss_fn`` over its microbatches within ``LOSS_RTOL32`` /
    ``GRAD_RTOL32``."""
    from repro_torch.interop import transformer_params_from_reference
    from repro_torch.optim.optimizers import tree_map
    from torch_parity import (LOSS_RTOL32, assert_grads_close32,
                              port_grad_leaves)
    cr, pn, mn = runs[SSM_FAULT_CASE]["numpy"][:3]
    bn = runs[SSM_FAULT_CASE]["accum_batch"]
    got = runs[SSM_FAULT_CASE]["accum"]
    n = ACCUM_B // ACCUM
    want, grads = _reference_microbatches(
        cr, pn, mn, bn, [list(range(i * n, (i + 1) * n))
                         for i in range(ACCUM)])
    per = ACCUM_B // 2
    apart, _ = _reference_microbatches(
        cr, pn, mn, bn, [[r * per + i for r in range(2)]
                         for i in range(ACCUM)])
    assert abs(apart["loss"] - want["loss"]) > LOSS_RTOL32 * abs(want["loss"])
    for k in ("loss", "xent"):
        assert abs(got["metrics"][0][k] - want[k]) <= \
            LOSS_RTOL32 * abs(want[k])
    flat = iter(got["grads"])
    tree = tree_map(lambda _: next(flat),
                    transformer_params_from_reference(pn))
    assert_grads_close32(port_grad_leaves(tree), grads)
    assert got["route"] == ROUTE_SPLIT


def test_data_axes_all_to_all_rows_over_pod_and_data(runs):
    """``DataAxes.all_to_all_rows`` over gloo on the (2, 2, 1) mesh's
    "pod" and "data" groups (the rows move over "data", then "pod"): each
    rank gets every rank's ``RAGGED`` rows for it, in rank order, the
    zero-sized parts included."""
    for me, rows in runs["ragged"]:
        assert rows.tolist() == [[r, me, i] for r in range(4)
                                 for i in range(RAGGED[r][me])]
