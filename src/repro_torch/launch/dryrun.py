"""The dry run, the port of the JAX package's ``launch/dryrun.py``: trace
every (architecture x input shape) on the production meshes with no real
allocation and record what a card would compute, move and hold.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh pod                   # 16x16, 256 ranks
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --split-serve                                 # the 2-pod pipeline

The reference lowers and compiles each step with ``jax.jit`` on a host
mesh of 256 or 512 fake devices and reads XLA's cost and memory analyses.
The port starts a ``fake`` process group of the mesh's size (rank 0 of
it; any group it starts it destroys), builds the mesh over it, makes the
step's inputs as fake CPU tensors (``FakeTensorMode``: shapes and dtypes
from ``launch.specs``' ``meta`` trees, the parameters, optimizer state and
cache as DTensors laid out by ``sharding.specs``), and runs the port's own
step (``launch.steps``, ``backend="ref"``: the plain versions, as the
reference's dispatch is off by default) once under a
``roofline.analysis.TraceCounter``: per-card FLOPs, bytes accessed
(unfused), collective bytes by op and mesh dim, the live storages' peak.

Each run writes ``experiments/dryrun/torch_<arch>_<shape>_<mesh>.json``
(``torch_`` first: no reference record is ever written; a train step in
``grad_accum`` > 1 microbatches adds ``_ga<grad_accum>``, beside the
record of one). A record's
``model_axis`` is the route its step took (``step.route``): ``split`` for
every stack of the registry, whose products split over "model" with one
layer's FSDP dims gathered at a time (heads, FFN columns, experts, SSD
heads, the vocabulary) and whose MoE dispatch is the whole batch's over
the data axes (``sharding.tensor_parallel``). A split serve's record
says ``split`` too (``pod_pipeline.ROUTE``): each stage on that route
over its pod's "data" and "model" ranks, the hop and the result moved as
each rank's (data, model) block. Layers run as a Python loop, so nothing
is counted once for many (``scan_counted`` is false). A record's
``data_split`` says how its batch (a train step's microbatch) lies over
the data axes (``sharding.context_parallel.data_split``): ``"rows"``,
``"sequence"`` (context parallelism: a decode step's cache slots, or a
prefill's, a pod stage's or a train microbatch's positions, over the data
axes, B = 1 at ``long_500k``, a split serve's microbatch of B/M rows, a
``train_4k`` microbatch of B/16 rows at ``grad_accum`` 16) or
``"whole"``. An MoE record's ``moe_dispatch_sizes`` says where the sizes
of its dispatch's all-to-all over the data axes came from: a real step
reads each layer's expert counts to the host, a traced one has no counts
to read, so each (data rank, row, expert) takes its even share of the
top-k assignments, capped by the capacity (``"balanced"``:
``models.layers.moe._exchange_plan``). Its ``moe_forward`` is the MoE
layers' forward calls' part of the counts (``calls``, ``flops``,
``bytes_accessed``; a train step's backward through them not included).
Dense records have neither key.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.launch.specs import (SHAPES, TOKEN_DTYPE, batch_meta,
                                      input_specs, mode_of, supported)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (TraceCounter, model_flops,
                                           terms_from_trace)
from repro_torch.sharding import specs as sh
from repro_torch.sharding.context_parallel import data_split
from repro_torch.sharding.tensor_parallel import contiguous_stride

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")

MEMORY_TRACKER = ("repro_torch.roofline.analysis.TraceCounter: the live "
                  "storages of the traced step on rank 0, its inputs "
                  "(the local shards, the whole batch) included")


def active_params(cfg, params_tree) -> int:
    """Parameter count active per token (MoE: top_k+shared of the experts)."""
    total = 0

    def count(path, leaf):
        nonlocal total
        keys = sh.path_keys(path)
        n = math.prod(leaf.shape)
        if cfg.moe is not None and "moe" in keys and keys[-1] in (
                "w_up", "w_down", "w_gate"):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    sh.tree_map_with_path(count, params_tree)
    return total


def _tree_bytes(tree) -> int:
    out = []
    sh.tree_map_with_path(
        lambda _, t: out.append(math.prod(t.shape) * t.element_size()),
        tree)
    return sum(out)


def analytic_memory(cfg, specs, mesh, mode) -> dict:
    """Per-device resident bytes from shardings (params/opt/cache/batch)."""
    n_dev = mesh.size()
    params_b = _tree_bytes(specs["params"])
    out = {"params_global": params_b, "params_per_device": params_b // n_dev}
    if mode == "train":
        out["opt_state_global"] = 2 * params_b     # m+v same dtypes
        out["batch_global"] = _tree_bytes(specs["batch"])
    elif mode == "decode":
        cache_b = _tree_bytes(specs["cache"])
        out["cache_global"] = cache_b
        out["cache_per_device"] = cache_b // n_dev
    return out


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``fake`` process group of ``world`` ranks (rank 0) for the
    duration, started and destroyed here when none exists; a group of that
    size already up is used as it is, one of another size refused."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry run needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def moe_forward_share(cfg) -> Iterator[Optional[dict]]:
    """While open, the stack's MoE layers' forward calls each counted by a
    ``TraceCounter`` of their own inside the step's: the dict it yields
    sums their ``calls``, ``flops`` and ``bytes_accessed`` (a train step's
    backward through them not included). None, and nothing patched, for a
    config without MoE layers."""
    if cfg.moe is None:
        yield None
        return
    real, share = tr.moe_forward, {"calls": 0, "flops": 0,
                                   "bytes_accessed": 0}

    def counted(*args, **kwargs):
        inner = TraceCounter()
        with inner:
            out = real(*args, **kwargs)
        share["calls"] += 1
        share["flops"] += inner.flops
        share["bytes_accessed"] += inner.bytes_accessed
        return out
    tr.moe_forward = counted
    try:
        yield share
    finally:
        tr.moe_forward = real


def _mesh_of(shape: Tuple[int, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _production_shape(multi_pod: bool) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def _mesh_name(shape: Tuple[int, ...]) -> str:
    if tuple(shape) == (16, 16):
        return "pod"
    if tuple(shape) == (2, 16, 16):
        return "multipod"
    return "x".join(map(str, shape))


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor of ``t``'s shape and dtype (inside the mode)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype)


def _placed(tree, specs, mesh):
    """Fake DTensors of ``tree``'s (``meta``) leaves laid out by
    ``specs``: each rank's local shard, the global shape. Other leaves
    (the optimizer's step count) stay as they are."""
    from torch.distributed.tensor import DTensor

    def put(_, sp, t):
        if not torch.is_tensor(t):
            return t
        local, _ = sh.local_shape_and_offset(t.shape, sp, mesh)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype), mesh, sh.placements(sp, mesh),
            run_check=False, shape=t.shape, stride=contiguous_stride(t.shape))
    return sh.tree_map_with_path(put, specs, tree, is_leaf=sh._is_spec)


def _memory_record(counter: TraceCounter) -> dict:
    return {"tracker": MEMORY_TRACKER,
            "peak_bytes_per_card": counter.peak_bytes,
            "fits": counter.peak_bytes <= hw.HBM_BYTES,
            "hbm_bytes": hw.HBM_BYTES}


def _collectives_record(coll) -> dict:
    return {"bytes_by_op": coll.bytes_by_op, "count_by_op": coll.count_by_op,
            "bytes_by_mesh_dim": coll.bytes_by_group,
            "bytes_by_op_and_mesh_dim": coll.bytes_by_op_and_group,
            "link_bytes_per_s_by_mesh_dim": coll.rate_by_group}


def _config(arch: str, smoke: bool, overrides: dict):
    get = get_smoke_config if smoke else get_config
    return get(arch).replace(**overrides)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str = OUT_DIR, opt_moment_dtype: Optional[str] = None,
            cfg_overrides: Optional[dict] = None, grad_accum: int = 1,
            mesh_shape: Optional[Tuple[int, ...]] = None,
            smoke: bool = False) -> dict:
    """Trace one (arch, shape) cell on the production mesh (or on
    ``mesh_shape``; ``smoke`` takes the registry's smoke config) and write
    its record. Returns the record (``status`` "skipped" with its reason
    for a pair ``supported`` refuses, and nothing written)."""
    # the reference's overrides; the port's Python loop has no scan to
    # unroll, so they change nothing here
    overrides = dict(scan_layers=False, attn_block_unroll=True)
    overrides.update(cfg_overrides or {})
    cfg = _config(arch, smoke, overrides)
    shape = tuple(mesh_shape or _production_shape(multi_pod))
    mesh_name = _mesh_name(shape)
    chips = math.prod(shape) if mesh_shape else (
        hw.MULTI_MESH_CARDS if multi_pod else hw.SINGLE_MESH_CARDS)
    S, B = SHAPES[shape_name]
    # a train step's microbatch lies over the data axes as its own rows do
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "grad_accum": grad_accum, "chips": chips,
           "data_split": data_split(B // grad_accum, S,
                                    math.prod(shape[:-1]))}
    ok, why = supported(cfg, shape_name)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = mode_of(shape_name)
    specs = input_specs(cfg, shape_name)
    moment_dtype = torch.bfloat16 if (
        opt_moment_dtype == "bfloat16"
        or (opt_moment_dtype is None and cfg.d_model >= 7168)) \
        else torch.float32
    with fake_group(rec["chips"]), moe_forward_share(cfg) as moe_share:
        mesh = _mesh_of(shape)
        t0 = time.time()
        with FakeTensorMode():
            pspecs = sh.param_specs(specs["params"], cfg, mesh)
            params = _placed(specs["params"], pspecs, mesh)
            counter = TraceCounter(mesh)
            if mode == "train":
                optimizer = adamw(constant(1e-4), moment_dtype=moment_dtype)
                opt_meta = optimizer.init(specs["params"])
                state = _placed(opt_meta,
                                sh.opt_state_specs(opt_meta, pspecs), mesh)
                batch = {k: _fake(v) for k, v in specs["batch"].items()}
                step = make_train_step(cfg, optimizer, grad_accum=grad_accum,
                                       device="cpu", mesh=mesh,
                                       backend="ref")
                route = step.route
                with counter:
                    counter.track(params, state, batch)
                    out = step(params, state, batch)
                del state
            elif mode == "prefill":
                batch = {k: _fake(v) for k, v in specs["batch"].items()}
                step = make_prefill_step(cfg, max_len=S, device="cpu",
                                         mesh=mesh, backend="ref")
                route = step.route
                with counter, torch.no_grad():
                    counter.track(params, batch)
                    out = step(params, batch)
            else:
                cache = _placed(specs["cache"],
                                sh.cache_specs(specs["cache"], cfg, mesh),
                                mesh)
                tokens = _fake(specs["tokens"])
                step = make_decode_step(cfg, device="cpu", mesh=mesh,
                                        backend="ref")
                route = step.route
                with counter, torch.no_grad():
                    counter.track(params, cache, tokens)
                    out = step(params, cache, tokens)
                del cache
            del out, params
        trace_s = time.time() - t0
    terms, coll = terms_from_trace(counter, rec["chips"])
    print(f"[{arch} {shape_name} {mesh_name}] flops={counter.flops:.3e} "
          f"bytes={counter.bytes_accessed:.3e} "
          f"peak={counter.peak_bytes:.3e}", flush=True)

    n_total = tr.param_count(specs["params"])
    n_active = active_params(cfg, specs["params"])
    mf = model_flops(cfg, shape_name, n_params_active=n_active)
    rec.update({
        "status": "ok",
        "scan_counted": False,
        "trace_s": round(trace_s, 2),
        "backend": "ref",
        "token_dtype": str(TOKEN_DTYPE).removeprefix("torch."),
        "model_axis": route,
        "memory_analysis": _memory_record(counter),
        "analytic_memory": analytic_memory(cfg, specs, mesh, mode),
        "cost_analysis": {"flops": float(counter.flops),
                          "bytes accessed": float(counter.bytes_accessed),
                          "bytes_accessed_unfused": True},
        "collectives": _collectives_record(coll),
        "roofline": terms.as_dict(),
        "params_total": n_total,
        "params_active": n_active,
        "model_flops": mf,
        "useful_flops_ratio": (mf / terms.flops_global)
        if terms.flops else None,
        "moment_dtype": (str(moment_dtype).removeprefix("torch.")
                         if mode == "train" else None),
    })
    if moe_share is not None:
        rec["moe_dispatch_sizes"] = "balanced"
        rec["moe_forward"] = moe_share
    accum = f"_ga{grad_accum}" if grad_accum > 1 else ""
    _write(rec, out_dir, f"torch_{arch}_{shape_name}_{mesh_name}{accum}.json")
    return rec


def _write(rec: dict, out_dir: str, name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def run_split_serve(arch: str, out_dir: str = OUT_DIR,
                    num_microbatches: int = 8, seq_len: int = 4096,
                    batch: int = 32, cfg_overrides: Optional[dict] = None,
                    mesh_shape: Tuple[int, ...] = (2, 16, 16),
                    smoke: bool = False) -> dict:
    """Tier-B pod-split serving dry run: trace the pod pipeline
    (``core.partition.pod_pipeline``) on the multi-pod mesh (or on a
    ("pod", "data", "model") ``mesh_shape``) and record its T_TX term (the
    hop's ``collective-permute`` bytes) beside the Eq. 5 latency model's
    prediction on ``h100_two_node``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.partition import pod_pipeline as pp
    from repro_torch.core.partition.latency_model import (
        split_latency, transformer_layer_costs)
    from repro_torch.core.partition.profiles import PROFILES

    cfg = _config(arch, smoke, dict(scan_layers=False,
                                    **(cfg_overrides or {})))
    if not pp.pipeline_supported(cfg):
        raise ValueError(f"{arch}: no single homogeneous run to pipeline")
    shape = tuple(mesh_shape)
    n_pods = shape[0]
    mesh_name = _mesh_name(shape)
    rec = {"arch": arch, "mode": "split_serve", "mesh": mesh_name,
           "chips": math.prod(shape), "num_microbatches": num_microbatches,
           "seq_len": seq_len, "batch": batch, "backend": "ref",
           "data_split": data_split(batch // num_microbatches, seq_len,
                                    shape[1])}
    params = tr.init_params(cfg, device="meta")
    sp = dict(params)
    sp["runs"] = [pp.stack_stage_params(params, cfg, n_pods)]
    with fake_group(rec["chips"]), moe_forward_share(cfg) as moe_share:
        mesh = _mesh_of(shape)
        t0 = time.time()
        with FakeTensorMode():
            placed = _placed(sp, pp.stage_param_specs(sp, cfg, mesh), mesh)
            # a VLM's batch carries its vision prefix (the reference's
            # passes tokens alone, which its embedding cannot take)
            batch_in = {k: _fake(v) for k, v in
                        batch_meta(cfg, batch, seq_len).items()}
            step = pp.make_split_serve_step(cfg, n_pods, num_microbatches,
                                            mesh, device="cpu", backend="ref")
            rec["model_axis"] = step.route
            counter = TraceCounter(mesh)
            with counter, torch.no_grad():
                counter.track(placed, batch_in)
                out = step(placed, batch_in)
            del out, placed
        rec["trace_s"] = round(time.time() - t0, 2)
    terms, coll = terms_from_trace(counter, rec["chips"])
    rec["memory_analysis"] = _memory_record(counter)
    rec["cost_analysis"] = {"flops": float(counter.flops),
                            "bytes accessed": float(counter.bytes_accessed),
                            "bytes_accessed_unfused": True}
    rec["collectives"] = _collectives_record(coll)
    rec["roofline"] = terms.as_dict()
    if moe_share is not None:
        rec["moe_dispatch_sizes"] = "balanced"
        rec["moe_forward"] = moe_share
    # Eq. 5 prediction for the same split (layer c = L/2)
    costs = transformer_layer_costs(cfg, seq_len)
    pred = split_latency(costs, cfg.num_layers // 2,
                         PROFILES["h100_two_node"], seq_len * cfg.d_model * 2)
    # per-request boundary bytes: activation (B/M, S, d) x M microbatches
    rec["eq5_profile"] = "h100_two_node"
    rec["eq5_prediction"] = {k: v * batch for k, v in pred.items()
                             if k.startswith("T")}
    rec["boundary_bytes_model"] = batch * seq_len * cfg.d_model * 2
    # what a card's hop moves: its (data, model) block of the microbatch
    # each tick, as the reference's 1/(data x model) shard; no angles
    rec["hop"] = {
        "ticks": num_microbatches + n_pods - 1,
        "collective_permute_bytes_per_card":
            coll.bytes_by_op.get("collective-permute", 0),
        "activation_shards_in_reference": math.prod(shape[1:])}
    _write(rec, out_dir, f"torch_{arch}_split_serve_{mesh_name}.json")
    print(f"[{arch} split_serve] trace={rec['trace_s']}s "
          f"permute_bytes="
          f"{coll.bytes_by_op.get('collective-permute', 0):.3e} "
          f"model_boundary_bytes={rec['boundary_bytes_model']:.3e}",
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--split-serve", action="store_true",
                    help="Tier-B pod-split pipeline dry run (multipod)")
    ap.add_argument("--pods-mesh", default="2x16x16",
                    help="the split serve's (pod, data, model) mesh")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.split_serve:
        run_split_serve(args.arch, args.out, mesh_shape=tuple(
            int(n) for n in args.pods_mesh.split("x")))
        return

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    pairs = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in pairs:
        for mp in meshes:
            try:
                rec = run_one(arch, shape, mp, args.out)
                status = rec["status"]
                extra = (f" trace={rec.get('trace_s')}s "
                         f"dominant={rec.get('roofline', {}).get('dominant')}"
                         if status == "ok" else f" ({rec.get('reason')})")
                print(f"== {arch} {shape} "
                      f"{'multipod' if mp else 'pod'}: {status}{extra}",
                      flush=True)
            except Exception:                                 # noqa: BLE001
                failures.append((arch, shape, mp))
                print(f"== {arch} {shape} {'multipod' if mp else 'pod'}: "
                      f"FAILED", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")


if __name__ == "__main__":
    main()
