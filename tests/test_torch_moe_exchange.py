"""The MoE dispatch over the data axes as an all-to-all of the kept rows
(``models.layers.moe``: ``_exchange_plan``, ``TensorParallel.send_rows``;
``sharding.tensor_parallel.all_to_all_rows``) in one process: the data
ranks are one ``SequentialRanks`` seam of 4 shares run one after another
(no spawn), on the same numpy arrays as the reference.

* ``all_to_all_rows`` delivers ragged parts, zero-sized ones included, in
  rank order: over ``SequentialRanks`` (one axis) and over a ``DataAxes``
  of a (2, 3) grid of thread axes ("pod" major), where each row crosses
  each axis at most once.
* The smoke Mixtral-8x7B, DeepSeek-V3 and a hand-made Mixtral of 2
  experts, top-1, capacity factor 0.5 (its whole-batch capacity binds),
  over 4 data shares, the rows split (B = 4, a row a share) and the
  sequence split (B = 1 of 16 positions, 4 a share): the prefill, 4
  decode steps and 2 AdamW steps (each share's loss and gradient by
  ``launch.steps.share_loss_and_grads``, summed in rank order, one
  update). Every tensor is ``torch.equal`` to the same shares' on the
  exchange the all-to-all replaced (``torch_ranks.slot_exchange``: the
  slot buffer reduce-scattered, the outputs all-gathered); the logits
  within ``stack_tol`` of the one-process steps and of the reference's
  ``prefill`` / ``decode_step``, each MoE layer's ``drop_frac`` exactly
  the reference ``moe_forward``'s on the whole batch, the first step's
  loss and gradient within ``LOSS_RTOL32`` / ``GRAD_RTOL32`` of
  ``jax.value_and_grad`` of its ``loss_fn``, the parameters after 2 steps
  within 4 ulp of a leaf's largest entry plus 1e-4 of one step's lr of
  the one-process ``make_train_step``'s. The 2-expert case's rows split
  sends no row from some rank to some rank."""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import transformer as tr
from repro_torch.models.layers import moe as moe_layer
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding.context_parallel import sequential_shares
from repro_torch.sharding.tensor_parallel import (DataAxes, SequentialRanks,
                                                  TensorParallel,
                                                  all_to_all_rows)
from torch_mesh_steps import configured
from torch_ranks import slot_exchange

#: (name, registry arch, config overrides)
CASES = (("mixtral-8x7b", "mixtral-8x7b", {}),
         ("deepseek-v3-671b", "deepseek-v3-671b", {}),
         ("mixtral-2-experts", "mixtral-8x7b",
          dict(moe=dict(num_experts=2, top_k=1, capacity_factor=0.5))))
NAMES = [c[0] for c in CASES]
#: split -> (rows, positions) of the batch
SPLITS = {"rows": (4, 8), "sequence": (1, 16)}
SHARES, DECODE, STEPS = 4, 4, 2
LR, EPS = 1e-3, 1e-3
METRIC_RTOL, PARAM_ULPS, UPDATE_RTOL = 1e-6, 4, 1e-4
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's smoke-size work (the suite runs
    it beside the other workers), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the collective
# ---------------------------------------------------------------------------
def _rows_of(rank: int, sizes) -> torch.Tensor:
    """Rank ``rank``'s rows for each rank in turn: row i to rank q is
    [rank, q, i]."""
    return torch.tensor([[rank, q, i] for q in range(len(sizes))
                         for i in range(sizes[rank][q])],
                        dtype=torch.float32).reshape(-1, 3)


def _delivered(q: int, sizes):
    return [[r, q, i] for r in range(len(sizes)) for i in range(sizes[r][q])]


#: ragged sizes[r][q] with zeros, a rank that sends nothing and a rank
#: that receives nothing
SIZES4 = [[2, 0, 1, 3], [0, 0, 0, 0], [1, 4, 0, 2], [5, 0, 2, 1]]


def test_sequential_ranks_all_to_all_rows_deliver_ragged_parts_in_rank_order():
    """Over one ``SequentialRanks`` axis of 4 ranks: each rank gets every
    rank's rows for it, in rank order, zero-sized parts included; its own
    part stays as it is."""
    ranks = SequentialRanks(4)
    got = ranks.run([lambda a=a: all_to_all_rows([a], _rows_of(a.rank,
                                                                SIZES4),
                                                 SIZES4)
                     for a in ranks.axes()])
    for q, rows in enumerate(got):
        assert rows.tolist() == _delivered(q, SIZES4)


class _ThreadGroup:
    def __init__(self, size: int):
        self.size, self.box = size, [None] * size
        self.barrier = threading.Barrier(size)


class _ThreadAxis:
    """One rank of a group of threads that run at once: ``all_to_all`` as
    the seam's (parts to ranks, the shapes each rank expects), counting
    the rows it sends to other ranks."""

    def __init__(self, group: _ThreadGroup, rank: int):
        self.group, self.rank, self.size = group, rank, group.size
        self.rows_sent = 0

    def all_to_all(self, parts, shapes):
        self.group.box[self.rank] = list(parts)
        self.rows_sent += sum(p.shape[0] for r, p in enumerate(parts)
                              if r != self.rank)
        self.group.barrier.wait()
        got = [self.group.box[r][self.rank].clone() for r in range(self.size)]
        self.group.barrier.wait()
        assert [tuple(t.shape) for t in got] == [tuple(s) for s in shapes]
        return got


def test_data_axes_all_to_all_rows_cross_each_axis_at_most_once():
    """A ``DataAxes`` of ("pod", "data") = (2, 3) thread axes, ranks
    numbered pod major: each rank gets every rank's rows for it in rank
    order (ragged, zero-sized parts included); each axis carries exactly
    the rows whose source and destination differ on it."""
    P, D = 2, 3
    n = P * D
    rng = np.random.default_rng(0)
    sizes = rng.choice([0, 0, 1, 2, 3], size=(n, n)).tolist()
    sizes[1] = [0] * n                       # a rank that sends nothing
    for r in range(n):
        sizes[r][4] = 0                      # a rank that receives nothing
    pods = [_ThreadGroup(P) for _ in range(D)]
    datas = [_ThreadGroup(D) for _ in range(P)]
    axes = [[_ThreadAxis(pods[g % D], g // D), _ThreadAxis(datas[g // D],
                                                           g % D)]
            for g in range(n)]
    got, failed = [None] * n, []

    def run(g):
        try:
            data = DataAxes(axes[g])
            assert data.rank == g and data.size == n
            got[g] = data.all_to_all_rows(_rows_of(g, sizes), sizes)
        except BaseException as e:          # noqa: BLE001
            failed.append(e)
            for grp in pods + datas:
                grp.barrier.abort()
    threads = [threading.Thread(target=run, args=(g,)) for g in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not failed
    for q in range(n):
        assert got[q].tolist() == _delivered(q, sizes)
    for g in range(n):                  # "data" first: a rank's own rows
        assert axes[g][1].rows_sent == sum(
            sizes[g][q] for q in range(n) if q % D != g % D)
    assert sum(a[0].rows_sent for a in axes) == sum(
        sizes[h][q] for h in range(n) for q in range(n) if q // D != h // D)


# ---------------------------------------------------------------------------
# the stacks over 4 data shares
# ---------------------------------------------------------------------------
class _Watch:
    """While open: each ``moe_forward`` call's (input rows, ``drop_frac``)
    and each ``_exchange_plan``'s sizes."""

    def __enter__(self):
        self.forward, self.plan = tr.moe_forward, moe_layer._exchange_plan
        self.calls, self.sizes = [], []

        def forward(params, moe, x, *args, **kw):
            out, metrics = self.forward(params, moe, x, *args, **kw)
            self.calls.append((x.detach().clone(),
                               float(metrics.drop_frac)))
            return out, metrics

        def plan(*args, **kw):
            sizes, at = self.plan(*args, **kw)
            self.sizes.append(sizes)
            return sizes, at
        tr.moe_forward, moe_layer._exchange_plan = forward, plan
        return self

    def __exit__(self, *exc):
        tr.moe_forward, moe_layer._exchange_plan = self.forward, self.plan


def _adamw():
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    return adamw(constant(LR), eps=EPS)


def _shares(cfg, params, batch, tokens, split: str) -> dict:
    """The 4 shares' prefill (the cache at S + DECODE slots), decode steps
    and ``STEPS`` AdamW steps, run one after another: every share's logits,
    each MoE call's ``drop_frac`` and the exchange's sizes, the first
    step's summed metrics and gradient, the parameters after."""
    B, S = batch["tokens"].shape
    max_len = S + DECODE
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    ranks = SequentialRanks(SHARES)
    if split == "rows":
        model = SequentialRanks(1).axes()[0]
        b = B // SHARES
        shares = [(TensorParallel.sliced(cfg, params, model, data=a),) * 2
                  for a in ranks.axes()]
        cut = [slice(r * b, (r + 1) * b) for r in range(SHARES)]
    else:
        shares = list(zip(*sequential_shares(cfg, params, ranks, max_len)))
        cut = [slice(None)] * SHARES

    def serve(r):
        pre, dec = shares[r]
        mine = {k: v[cut[r]] for k, v in inputs.items()}
        logits, cache = tr.prefill(params, cfg, mine, max_len=max_len,
                                   tp=pre)
        out = [logits]
        for t in tokens:
            logits, cache = tr.decode_step(params, cfg, cache, t[cut[r]],
                                           tp=dec)
            out.append(logits)
        return out
    with torch.no_grad(), _Watch() as watch:
        logits = ranks.run([lambda r=r: serve(r) for r in range(SHARES)])
    out = {"logits": logits, "calls": watch.calls, "sizes": watch.sizes}
    out.update(_train_shares(cfg, params, batch, split))
    return out


def _train_shares(cfg, params, batch, split: str) -> dict:
    from repro_torch.launch.steps import share_loss_and_grads
    opt = _adamw()
    state, p, out = opt.init(params), params, {}
    for i in range(STEPS):
        ranks = SequentialRanks(SHARES)
        parts = ranks.run([lambda a=a: share_loss_and_grads(
            cfg, p, batch, a, split=split) for a in ranks.axes()])
        grads = parts[0][1]
        for _, g, _ in parts[1:]:
            grads = tree_map(torch.add, grads, g)
        metrics = {k: sum(float(m[k].to(torch.float32) * s)
                          for m, _, s in parts) for k in parts[0][0]}
        if i == 0:
            out["metrics"], out["grads"] = metrics, tree_leaves(grads)
            out["share_grads"] = [tree_leaves(g) for _, g, _ in parts]
        p, state = opt.update(grads, state, p)
    out["params"] = tree_leaves(p)
    return out


_SETUPS: dict = {}


def _setup(name: str, split: str) -> dict:
    """The case's trees and batch, its 4 shares on the all-to-all and on
    the slot exchange, the one-process steps: made once a case and split."""
    key = (name, split)
    if key in _SETUPS:
        return _SETUPS[key]
    from repro.configs import registry as rreg
    from repro_torch.interop import transformer_params_from_reference
    from torch_parity import train_batch_np, transformer_params_np
    _, arch, over = next(c for c in CASES if c[0] == name)
    cr = configured(rreg.get_smoke_config(arch), over)
    cfg = configured(get_smoke_config(arch), over)
    B, S = SPLITS[split]
    pn = transformer_params_np(cr, seed=3)
    bn = train_batch_np(cr, B, S, seed=5)
    toks = np.random.default_rng(6).integers(0, cr.vocab_size,
                                             (DECODE, B, 1))
    params = transformer_params_from_reference(pn)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in bn.items()}
    tokens = [torch.as_tensor(t, dtype=torch.long) for t in toks]
    got = _shares(cfg, params, batch, tokens, split)
    with slot_exchange():
        slots = _shares(cfg, params, batch, tokens, split)
    out = dict(cfg=cfg, cr=cr, pn=pn, bn=bn, toks=toks, got=got,
               slots=slots, one=_one_process(cfg, params, batch, tokens))
    _SETUPS[key] = out
    return out


def _one_process(cfg, params, batch, tokens) -> dict:
    from repro_torch.launch.steps import make_train_step
    S = batch["tokens"].shape[1]
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad(), _Watch() as watch:
        logits, cache = tr.prefill(params, cfg, inputs, max_len=S + DECODE)
        out = {"logits": [logits]}
        for t in tokens:
            logits, cache = tr.decode_step(params, cfg, cache, t)
            out["logits"].append(logits)
    out["calls"] = watch.calls
    opt = _adamw()
    step = make_train_step(cfg, opt, device="cpu")
    p, state = params, opt.init(params)
    out["metrics"] = []
    for _ in range(STEPS):
        p, state, m = step(p, state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = tree_leaves(p)
    return out


def _joined_logits(split: str, per_share):
    """The whole batch's logits of one step from the shares': the rows'
    joined (rows split), else the first share's (every share's the same)."""
    if split == "rows":
        return torch.cat(per_share)
    assert all(torch.equal(t, per_share[0]) for t in per_share[1:])
    return per_share[0]


def _close(got, want):
    from torch_parity import stack_tol, to_f32
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= stack_tol(want, "float32")


PAIRS = [(n, s) for n in NAMES for s in SPLITS]
IDS = [f"{n}-{s}" for n, s in PAIRS]


@pytest.mark.parametrize("name,split", PAIRS, ids=IDS)
def test_all_to_all_gives_the_slot_exchange_bits(name, split):
    """Every share's prefill and decode logits, each MoE call's
    ``drop_frac``, the first step's metrics and every share's gradient,
    and the parameters after 2 AdamW steps: ``torch.equal`` to the same
    shares' on the slot exchange (the same rows reach the same slots and
    come back to the same places; the expert products run on the same
    blocks)."""
    s = _setup(name, split)
    got, want = s["got"], s["slots"]
    assert want["sizes"] == [] and got["sizes"]
    for g, w in zip(got["logits"], want["logits"]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert [d for _, d in got["calls"]] == [d for _, d in want["calls"]]
    assert got["metrics"] == want["metrics"]
    for g, w in zip(got["share_grads"], want["share_grads"]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                 want["params"]))


@pytest.mark.parametrize("name,split", PAIRS, ids=IDS)
def test_all_to_all_shares_match_one_process(name, split):
    """The shares' logits, joined, within ``stack_tol`` of the one-process
    prefill and decode steps; each prefill MoE layer's ``drop_frac`` the
    one-process run's (the whole batch's) on every share; the first step's
    metrics within 1e-6 relative, the parameters after 2 AdamW steps
    within 4 ulp of a leaf's largest entry plus 1e-4 of one step's lr."""
    s = _setup(name, split)
    got, one = s["got"], s["one"]
    steps = list(zip(*got["logits"]))
    assert len(steps) == len(one["logits"]) == DECODE + 1
    for g, w in zip(steps, one["logits"]):
        _close(_joined_logits(split, g), w)
    m = len(one["calls"]) // (DECODE + 1)
    want = [d for _, d in one["calls"][:m]]
    assert sorted(d for _, d in got["calls"][:SHARES * m]) == \
        sorted(want * SHARES)
    for k, v in one["metrics"][0].items():
        assert abs(got["metrics"][k] - v) <= METRIC_RTOL * max(abs(v), 1.0)
    for g, w in zip(got["params"], one["params"]):
        tol = PARAM_ULPS * EPS32 * float(w.abs().max()) + UPDATE_RTOL * LR
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("name,split", PAIRS, ids=IDS)
def test_all_to_all_shares_match_reference(name, split):
    """The shares' logits, joined, within ``stack_tol`` of the reference's
    ``prefill`` and ``decode_step`` on the whole batch; each MoE layer's
    ``drop_frac`` the reference ``moe_forward``'s on that layer's whole
    input; the first step's loss within ``LOSS_RTOL32`` and summed
    gradient within ``GRAD_RTOL32`` of ``jax.value_and_grad`` of its
    ``loss_fn`` (the reference's steps jitted: op by op they took several
    times as long)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as rtr
    from repro.models.layers.moe import moe_forward as rmoe
    from repro_torch.interop import transformer_params_from_reference
    from torch_parity import (LOSS_RTOL32, assert_grads_close32,
                              port_grad_leaves, to_f32)
    s = _setup(name, split)
    cr, pn, bn, got = s["cr"], s["pn"], s["bn"], s["got"]
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    inputs = {k: v for k, v in bn.items() if k != "labels"}
    S = bn["tokens"].shape[1]
    prefill = jax.jit(lambda p, b: rtr.prefill(p, cr, b, max_len=S + DECODE))
    decode = jax.jit(lambda p, c, t: rtr.decode_step(p, cr, c, t))
    logits, cache = prefill(j(pn), j(inputs))
    want = [to_f32(logits)]
    for t in s["toks"]:
        logits, cache = decode(j(pn), cache, jnp.asarray(t, jnp.int32))
        want.append(to_f32(logits))
    for g, w in zip(zip(*got["logits"]), want):
        _close(_joined_logits(split, g), w)
    layers = [(r, i) for r, run in enumerate(tr.layer_runs(cr))
              if run.kind == "moe" for i in range(run.count)]
    drop = jax.jit(lambda p, x: rmoe(p, cr.moe, x,
                                     cr.activation)[1].drop_frac)
    for (r, i), (x, d) in zip(layers, s["one"]["calls"]):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]),
                                   pn["runs"][r]["moe"])
        assert d == float(drop(p, jnp.asarray(x.numpy())))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: rtr.loss_fn(p, cr, b, None), has_aux=True))(j(pn),
                                                                 j(bn))
    loss = float(loss)
    assert abs(got["metrics"]["loss"] - loss) <= LOSS_RTOL32 * abs(loss)
    flat = iter(got["grads"])
    tree = tree_map(lambda _: next(flat),
                    transformer_params_from_reference(pn))
    grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    assert_grads_close32(port_grad_leaves(tree), grads)


def test_a_binding_capacity_sends_no_row_between_some_ranks():
    """The 2-expert Mixtral's rows split: some rank sends no row to some
    other rank (a zero-sized part of the all-to-all), and some rank sends
    rows to another (the exchange is not the identity)."""
    sizes = _setup("mixtral-2-experts", "rows")["got"]["sizes"]
    off = [row[q] for m in sizes for r, row in enumerate(m)
           for q in range(SHARES) if q != r]
    assert 0 in off and max(off) > 0

