"""Context parallelism over the data axes for serving and training
(``repro_torch.sharding.context_parallel``) in one process: the data
ranks of a sequence split are one ``SequentialRanks`` seam (their shares
run one after another, every exchange in rank order; no spawn), on the
same numpy arrays as the reference (``tests/torch_parity.py``).

* The stacks: a prefill (logits and cache) and 4 decode steps at B = 1
  over 2 and 4 sequence shares (``sequential_shares``) of the smoke
  Qwen2-7B, Qwen2-VL-7B (its vision prefix joined before the cut, M-RoPE
  grid ids cut with it), HuBERT-XLarge (bidirectional: every position's
  logits, each share its block), Mixtral-8x7B at S = 128 with its window
  of 64 (the rolling cache's slots cross the shares), DeepSeek-V3 (MLA's
  latents gathered, an MoE layer), Mamba2-2.7B at S = 40 (blocks of 20
  and 10 positions, not multiples of its chunk of 32: the SSD state
  carried across the blocks, the conv's halo) and Zamba2-1.2B. Every
  share's logits have the same bits; they, and the cache (each share's
  slots joined), are within ``stack_tol`` of the port's one-process steps
  and of the reference's unsharded ``prefill`` / ``decode_step``; each MoE
  layer's ``drop_frac`` equals the one-process run's and the reference
  ``moe_forward``'s on that layer's input, exactly.
* Slots the shares do not divide: ``max_len`` = S + 5, odd, where every
  share keeps each KV or MLA leaf whole (``cache_specs``), for a Mixtral
  whose window of 24 lies between S = 16 and 2 ``max_len`` (its rolling
  cache holds all 21 slots) and for DeepSeek-V3's latents: held as the
  stacks above are, against the one-process steps.
* The whole batch's dispatch on a sequence split: a hand-made Mixtral of
  2 experts, top-1, capacity factor 0.5 at B = 2 over 4 shares, where
  the capacity binds. An assignment's slot counts the earlier rows'
  tokens and the same row's lower shares' (the reference's (b, s)
  order): the layer's output and ``drop_frac`` equal the reference's on
  the whole batch, where the rows' order of the split over rows (every
  lower rank's tokens first) keeps other assignments; the stack's prefill
  and decode steps at B = 2 hold the reference's.
* The flash kernel's query offset: the plain twin (and the wrapper's CPU
  path) at ``q_offset`` > 0 against the reference's ``chunked_attention``
  at shifted query positions, causal, windowed and not causal, and the
  offset backward against ``jax.vjp`` of it, within 64 eps of the largest
  entry (float32).

* The train step on a sequence split: the 7 configs (Mixtral with a
  window of 6 that crosses the blocks) at B = 1 over 2 and 4 shares
  (``launch.steps.share_loss_and_grads``), the loss within
  ``LOSS_RTOL32`` and every gradient leaf, summed over the shares, within
  ``GRAD_RTOL32`` of the reference's ``jax.value_and_grad`` of
  ``loss_fn`` on the whole batch; each exchange's backward (the K/V
  gather, the conv halo, the SSD carry) against autograd of the unsplit
  function, within 64 eps of the largest entry.

Float32 configs throughout: ``stack_tol`` is 64 eps of the largest logit
(the same sums in other orders: the partial softmaxes combined, the
state folded in rank order)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.requests import request_batch
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_backward)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import transformer as tr
from repro_torch.models.layers.moe import moe_forward
from repro_torch.sharding.context_parallel import (SeqSplit, data_split,
                                                   sequential_shares)
from repro_torch.sharding.tensor_parallel import (SequentialRanks,
                                                  TensorParallel)
from torch_parity import EPS32, stack_tol, to_f32, transformer_params_np

#: (name, registry arch, config overrides, positions S)
CASES = (("qwen2-7b", "qwen2-7b", {}, 16),
         ("qwen2-vl-7b", "qwen2-vl-7b", {}, 32),
         ("hubert-xlarge", "hubert-xlarge", {}, 16),
         ("mixtral-8x7b", "mixtral-8x7b", {}, 128),
         ("deepseek-v3-671b", "deepseek-v3-671b", {}, 16),
         ("mamba2-2.7b", "mamba2-2.7b", {}, 40),
         ("zamba2-1.2b", "zamba2-1.2b", {}, 16))
NAMES = [c[0] for c in CASES]
SHARES = (2, 4)
DECODE = 4
#: the whole-batch dispatch case: 2 experts, top-1, capacity factor 0.5
CAPACITY = ("mixtral-2-experts", "mixtral-8x7b",
            dict(moe=dict(num_experts=2, top_k=1, capacity_factor=0.5)), 32)
CAPACITY_B, CAPACITY_SHARES = 2, 4
#: cases whose cache's ``max_len`` = S + DECODE + 1 is odd: no share count
#: divides the slots
WHOLE_SLOT_CASES = (("mixtral-window-24", "mixtral-8x7b",
                     dict(sliding_window=24), 16),
                    ("deepseek-v3-671b", "deepseek-v3-671b", {}, 16))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's smoke-size work (the suite
    runs it beside the other workers), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configured(cfg, over):
    """``cfg`` in float32 with the case's overrides (``moe``: fields of
    its ``MoEConfig``), for either package's config."""
    over = dict(over)
    if over.get("moe"):
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return cfg.replace(dtype="float32", **over)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class _WatchMoE:
    """Each ``moe_forward`` call of the stack while open: (its input rows,
    ``drop_frac``), in call order (a split's calls rank after rank)."""

    def __enter__(self):
        self.real, self.calls = tr.moe_forward, []

        def watched(params, moe, x, *args, **kw):
            out, metrics = self.real(params, moe, x, *args, **kw)
            self.calls.append((x.detach().clone(), float(metrics.drop_frac)))
            return out, metrics
        tr.moe_forward = watched
        return self.calls

    def __exit__(self, *exc):
        tr.moe_forward = self.real


_SETUPS: dict = {}


def _setup(case, B: int = 1, max_len: int = 0, reference: bool = True):
    """The case's configs, numpy trees and batch, the port's one-process
    run and (where ``reference``) the reference's, the cache at
    ``max_len`` slots (default: S + DECODE): made once a case (both share
    counts)."""
    name, arch, over, S = case
    max_len = max_len or S + DECODE
    key = (name, B, max_len)
    if key in _SETUPS:
        return _SETUPS[key]
    from repro.configs import registry as rreg
    from repro.models import transformer as rtr
    from repro_torch.interop import transformer_params_from_reference
    cr = _configured(rreg.get_smoke_config(arch), over)
    cfg = _configured(get_smoke_config(arch), over)
    pn = transformer_params_np(cr, seed=3)
    rng = np.random.default_rng(5)
    bn = request_batch(cr, B, S, rng, grid=True)
    toks = rng.integers(0, cr.vocab_size, (DECODE, B, 1))
    params = transformer_params_from_reference(pn)
    batch = {k: torch.as_tensor(v) for k, v in bn.items()}
    tokens = [torch.as_tensor(t, dtype=torch.long) for t in toks]
    with torch.no_grad(), _WatchMoE() as calls:
        one = _serve(cfg, params, batch, tokens, max_len)
    one["moe"] = calls
    out = dict(cfg=cfg, cr=cr, pn=pn, params=params, batch=batch,
               tokens=tokens, max_len=max_len, one=one, ref=None, S=S)
    _SETUPS[key] = out
    if not reference:
        return out
    # the reference's steps jitted (compiled once a case: op by op they
    # took several times as long)
    prefill = jax.jit(lambda p, b: rtr.prefill(p, cr, b, max_len=max_len))
    decode = jax.jit(lambda p, c, t: rtr.decode_step(p, cr, c, t))
    logits, cache = prefill(_j(pn), _j(bn))
    ref = {"logits": [to_f32(logits)]}
    if cfg.moe is not None:         # the prefill's MoE layers' inputs
        m = len(calls) // (DECODE + 1)
        ref["drops"] = _reference_drops(cr, pn, [x for x, _ in calls[:m]])
    if cache is not None:
        for t in toks:
            logits, cache = decode(_j(pn), cache, jnp.asarray(t, jnp.int32))
            ref["logits"].append(to_f32(logits))
    out["ref"] = ref
    return out


def _serve(cfg, params, batch, tokens, max_len, pre=None, dec=None):
    """A prefill and the decode steps (with ``pre``/``dec``: one share's
    ``TensorParallel``s): the logits, and the cache's leaves after the
    prefill and after the last step (copies)."""
    logits, cache = tr.prefill(params, cfg, batch, max_len=max_len, tp=pre)
    out = {"logits": [logits], "cache": None}
    if cache is None:
        return out
    out["cache"] = [t.clone() for t in _cache_leaves(cache)]
    for t in tokens:
        logits, cache = tr.decode_step(params, cfg, cache, t, tp=dec)
        out["logits"].append(logits)
    out["cache_after"] = [t.clone() for t in _cache_leaves(cache)]
    return out


def _cache_leaves(cache):
    from repro_torch.optim.optimizers import tree_leaves
    return tree_leaves({k: v for k, v in cache.items() if k != "pos"})


def _split_run(setup, n: int):
    """The case's prefill and decode steps over ``n`` sequence shares run
    one after another; with each share's MoE calls."""
    ranks = SequentialRanks(n)
    pre, dec = sequential_shares(setup["cfg"], setup["params"], ranks,
                                 setup["max_len"])
    with torch.no_grad(), _WatchMoE() as calls:
        res = ranks.run([lambda p=p, d=d: _serve(
            setup["cfg"], setup["params"], setup["batch"], setup["tokens"],
            setup["max_len"], p, d) for p, d in zip(pre, dec)])
    return res, calls


def _joined(parts, whole):
    """One cache leaf from every share's part: joined on the slot dim (2:
    (L, B, slots, ...)) where the shares split it, else the first's (each
    holds it whole)."""
    if parts[0].shape == whole.shape:
        return parts[0]
    return torch.cat(parts, dim=2)


def _close(got, want):
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= stack_tol(want, "float32")


def _reference_drops(cr, pn, inputs):
    """``drop_frac`` of the reference ``moe_forward`` of each MoE layer (in
    layer order) on that layer's input rows ``inputs``."""
    from repro.models.layers.moe import moe_forward as rmoe
    layers = [(r, j) for r, run in enumerate(tr.layer_runs(cr))
              if run.kind == "moe" for j in range(run.count)]
    drop = jax.jit(lambda p, x: rmoe(p, cr.moe, x,
                                     cr.activation)[1].drop_frac)
    out = []
    for (r, j), x in zip(layers, inputs):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[j]),
                                   pn["runs"][r]["moe"])
        out.append(float(drop(p, jnp.asarray(x.numpy()))))
    return out


def _check_split(setup, n: int, whole_slots: bool = False):
    """The ``n``-share split's prefill and decode steps at B = 1: every
    share's logits the same bits (a bidirectional config's: its block of
    the positions), within ``stack_tol`` of the one-process steps' and of
    the reference's (where the setup holds it); the cache, each share's
    slots joined (with
    ``whole_slots``: each share's whole leaf), within ``stack_tol`` of the
    one-process cache after the prefill and after the last step; each MoE
    layer's ``drop_frac`` the one-process run's (and the reference's),
    exactly."""
    cfg, one, ref = setup["cfg"], setup["one"], setup["ref"]
    assert data_split(1, setup["S"], n) == "sequence"
    res, calls = _split_run(setup, n)
    wants = [one] if ref is None else [one, ref]
    if not cfg.causal:
        got = torch.cat([r["logits"][0] for r in res], dim=1)
        for want in wants:
            _close(got, want["logits"][0])
        return
    for r in res[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(r["logits"], res[0]["logits"]))
    for want in wants:
        assert len(res[0]["logits"]) == len(want["logits"]) == DECODE + 1
        for g, w in zip(res[0]["logits"], want["logits"]):
            _close(g, w)
    for key in ("cache", "cache_after"):
        for i, w in enumerate(one[key]):
            parts = [r[key][i] for r in res]
            if whole_slots:
                for part in parts:
                    _close(part, w)
            else:
                _close(_joined(parts, w), w)
    if cfg.moe is not None:
        m = len(one["moe"]) // (DECODE + 1)      # MoE layers a call
        want = [d for _, d in one["moe"][:m]]
        if ref is not None:
            assert want == ref["drops"]
        # the prefill's calls (the shares' in turns): the whole batch's
        assert sorted(d for _, d in calls[:n * m]) == sorted(want * n)


@pytest.mark.parametrize("n", SHARES)
@pytest.mark.parametrize("name", NAMES)
def test_sequence_split_serves_the_unsharded_logits_and_cache(name, n):
    """The ``n``-share split of the case, held by ``_check_split``."""
    _check_split(_setup(next(c for c in CASES if c[0] == name)), n)


@pytest.mark.parametrize("n", SHARES)
@pytest.mark.parametrize("name", [c[0] for c in WHOLE_SLOT_CASES])
def test_sequence_split_keeps_slots_it_does_not_divide_whole(name, n):
    """A cache of ``max_len`` = S + 5 slots, which neither share count
    divides: every share holds each leaf whole and writes every slot, its
    attention its own (no combine), held by ``_check_split`` against the
    one-process steps (the mesh run of the same cases holds the
    reference's: ``tests/test_torch_tensor_parallel.py``); the windowed
    Mixtral's rolling cache takes all ``max_len`` slots (S < window < 2
    ``max_len``), its slot and window in those slots."""
    case = next(c for c in WHOLE_SLOT_CASES if c[0] == name)
    _check_split(_setup(case, max_len=case[3] + DECODE + 1,
                        reference=False), n, whole_slots=True)


def _capacity_layer(setup):
    """Layer 0's MoE of the capacity case on random rows (B, S, d): the
    reference ``moe_forward``'s output and ``drop_frac`` on the whole
    batch, and the port's over ``CAPACITY_SHARES`` sequence shares with
    the split's slot order, and with the row split's (every lower rank's
    tokens first)."""
    from repro.models.layers.moe import moe_forward as rmoe
    cfg, cr, pn, params = (setup[k] for k in ("cfg", "cr", "pn", "params"))
    x = np.random.default_rng(9).standard_normal(
        (CAPACITY_B, setup["S"], cfg.d_model)).astype(np.float32)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                               pn["runs"][0]["moe"])
    out, metrics = jax.jit(lambda p, x: rmoe(p, cr.moe, x, cr.activation))(
        p, jnp.asarray(x))
    model = SequentialRanks(1).axes()[0]

    def port(seq: bool):
        ranks = SequentialRanks(CAPACITY_SHARES)
        shares = [TensorParallel.sliced(cfg, params, model, data=a,
                                        seq=SeqSplit(a) if seq else None)
                  for a in ranks.axes()]
        xt = torch.from_numpy(x)

        def share(tp):
            block = SeqSplit(tp.data).cut(xt, 1)
            o, mt = moe_forward(tp.layer(0, 0)["moe"], cfg.moe, block,
                                cfg.activation, tp=tp)
            return o, float(mt.drop_frac)
        with torch.no_grad():
            got = ranks.run([lambda tp=tp: share(tp) for tp in shares])
        return torch.cat([o for o, _ in got], 1), [d for _, d in got]
    return to_f32(out), float(metrics.drop_frac), port(True), port(False)


def test_sequence_split_dispatches_the_whole_batch_in_its_order():
    """The capacity case's MoE layer at B = 2 over 4 sequence shares: its
    output and ``drop_frac`` are the reference's on the whole batch (the
    capacity binds: assignments drop), every share with the same
    ``drop_frac``; the row split's slot order (every lower rank's tokens
    first, the rows' order) keeps other assignments, and its output is
    off the reference's. The stack's prefill and 4 decode steps at B = 2
    over the 4 shares hold the reference's logits and the one-process
    steps', and each prefill's ``drop_frac`` the one-process run's."""
    setup = _setup(CAPACITY, B=CAPACITY_B)
    want, drop, (seq_out, seq_drops), (row_out, _) = _capacity_layer(setup)
    assert drop > 0
    assert seq_drops == [drop] * CAPACITY_SHARES
    _close(seq_out, want)
    assert np.abs(to_f32(row_out) - want).max() > stack_tol(want, "float32")
    res, calls = _split_run(setup, CAPACITY_SHARES)
    for g, w, rw in zip(res[0]["logits"], setup["one"]["logits"],
                        setup["ref"]["logits"]):
        _close(g, w)
        _close(g, rw)
    m, n = setup["cfg"].num_layers, CAPACITY_SHARES
    assert sorted(d for _, d in calls[:n * m]) == sorted(
        [d for _, d in setup["one"]["moe"][:m]] * n)


# ---------------------------------------------------------------------------
# the flash kernel's query offset
# ---------------------------------------------------------------------------
#: (name, B, Sq, Sk, H, Hkv, D, q_offset, causal, window)
OFFSETS = [("causal", 2, 8, 24, 4, 2, 16, 16, True, None),
           ("causal_block", 1, 6, 18, 4, 1, 8, 6, True, None),
           ("window", 1, 8, 16, 4, 2, 16, 8, True, 5),
           ("noncausal", 1, 8, 24, 2, 2, 16, 8, False, None),
           ("noncausal_window", 1, 8, 24, 4, 2, 8, 8, False, 3)]


def _offset_inputs(case, rng):
    _, B, Sq, Sk, H, Hkv, D, *_ = case
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, g


def _reference_chunked(case):
    """The reference's ``chunked_attention`` with query positions from
    ``q_offset`` and keys from 0 (blocks of 8 keys, one padded)."""
    from repro.models.layers.attention import chunked_attention
    _, B, Sq, Sk, _, _, D, off, causal, window = case
    qpos = jnp.broadcast_to(jnp.arange(off, off + Sq)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    return lambda q, k, v: chunked_attention(
        q, k, v, qpos, kpos, causal, window, D ** -0.5, block_kv=8)


_OFFSET_REFERENCE: dict = {}


def _reference_offset(case):
    """(output, (dq, dk, dv)) of the reference's ``chunked_attention`` at
    the case's shifted positions on its inputs: one jitted ``jax.vjp``,
    made once a case."""
    if case[0] not in _OFFSET_REFERENCE:
        q, k, v, g = _offset_inputs(case, np.random.default_rng(11))

        def both(q, k, v, g):
            out, pullback = jax.vjp(_reference_chunked(case), q, k, v)
            return out, pullback(g)
        out, grads = jax.jit(both)(*(jnp.asarray(t) for t in (q, k, v, g)))
        _OFFSET_REFERENCE[case[0]] = ((q, k, v, g), np.asarray(out),
                                      [np.asarray(t) for t in grads])
    return _OFFSET_REFERENCE[case[0]]


def _tight(got, want):
    got, want = to_f32(got), to_f32(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= 64 * EPS32 * max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("case", OFFSETS, ids=[c[0] for c in OFFSETS])
def test_flash_plain_twin_at_an_offset_matches_shifted_positions(case):
    """``attention_ref`` and the wrapper's CPU path at ``q_offset``
    against the reference's ``chunked_attention`` at query positions
    ``q_offset`` .. ``q_offset + Sq - 1``; at ``q_offset`` = 0 the wrapper
    is the plain twin without one."""
    *_, off, causal, window = case
    (q, k, v, _), want, _ = _reference_offset(case)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    assert _tight(attention_ref(tq, tk, tv, q_offset=off, **kw), want)
    assert _tight(flash_attention(tq, tk, tv, q_offset=off, **kw), want)
    assert torch.equal(flash_attention(tq, tk, tv, **kw),
                       attention_ref(tq, tk, tv, **kw))


@pytest.mark.parametrize("case", OFFSETS, ids=[c[0] for c in OFFSETS])
def test_flash_backward_at_an_offset_matches_reference_vjp(case):
    """``flash_attention_backward`` at ``q_offset`` (and autograd through
    the wrapper, whose Function carries the offset) against ``jax.vjp``
    of the reference's ``chunked_attention`` at the shifted positions."""
    _, _, _, Sk, _, _, D, off, causal, window = case
    (q, k, v, g), _, want = _reference_offset(case)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = flash_attention_backward(tq, tk, tv, tg, causal, window,
                                   D ** -0.5, Sk, off)
    for a, b in zip(got, want):
        assert _tight(a, b)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*leaves, causal=causal, window=window,
                    q_offset=off).backward(tg)
    for a, b in zip(leaves, want):
        assert _tight(a.grad, b)


# ---------------------------------------------------------------------------
# the train step on a sequence split
# ---------------------------------------------------------------------------
#: (name, registry arch, config overrides, positions S) of the sequence
#: split's train step, B = 1, float32, masks at ratios in [0.3, 0.8): the
#: Mixtral's window of 6 crosses the blocks (8 and 4 positions); the
#: Qwen2-VL's S counts its text, its 16 vision tokens come first
TRAIN_CASES = (("qwen2-7b", "qwen2-7b", {}, 16),
               ("qwen2-vl-7b", "qwen2-vl-7b", {}, 16),
               ("hubert-xlarge", "hubert-xlarge", {}, 16),
               ("mixtral-window-6", "mixtral-8x7b", dict(sliding_window=6),
                16),
               ("deepseek-v3-671b", "deepseek-v3-671b", {}, 16),
               ("mamba2-2.7b", "mamba2-2.7b", {}, 40),
               ("zamba2-1.2b", "zamba2-1.2b", {}, 16))

_TRAIN: dict = {}


def _train_setup(case):
    """The case's port config, params, masks and batch, and the
    reference's loss and gradient leaves (``jax.value_and_grad`` of its
    ``loss_fn`` on the whole batch): made once a case."""
    from repro_torch.interop import (transformer_masks_from_reference,
                                     transformer_params_from_reference)
    from torch_parity import (port_batch, reference_loss_and_grads,
                              train_batch_np, train_setup)
    name, arch, over, S = case
    if name not in _TRAIN:
        cr, ct, pn, mn = train_setup(arch, **over)
        bn = train_batch_np(cr, 1, S)
        _TRAIN[name] = dict(
            cfg=ct, params=transformer_params_from_reference(pn),
            masks=transformer_masks_from_reference(mn),
            batch=port_batch(bn),
            ref=reference_loss_and_grads(cr, pn, bn, mn))
    return _TRAIN[name]


def _train_split(setup, n: int):
    """(loss, gradient tree) of the ``n``-share sequence split's train
    step (``launch.steps.share_loss_and_grads`` a share, the shares run in
    turn): each share's loss times its share summed, the shares'
    gradients summed in rank order."""
    from repro_torch.launch.steps import share_loss_and_grads
    from repro_torch.optim.optimizers import tree_map
    ranks = SequentialRanks(n)
    res = ranks.run([lambda a=a: share_loss_and_grads(
        setup["cfg"], setup["params"], setup["batch"], a, setup["masks"])
        for a in ranks.axes()])
    assert abs(sum(float(s) for *_, s in res) - 1.0) <= 4 * EPS32
    loss = sum(float(m["loss"]) * float(s) for m, _, s in res)
    grads = res[0][1]
    for _, g, _ in res[1:]:
        grads = tree_map(torch.add, grads, g)
    return loss, grads


@pytest.mark.parametrize("n", SHARES)
@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_sequence_split_trains_the_whole_batch(name, n):
    """The case's train step over ``n`` sequence shares: the loss (each
    share's times its share of the labels, summed) within ``LOSS_RTOL32``
    of the reference's ``jax.value_and_grad`` of ``loss_fn`` on the whole
    batch, and every gradient leaf (the shares' summed) within
    ``GRAD_RTOL32`` of its largest entry: K and V (MLA's latents, the MTP
    block's) gathered with their gradient reduce-scattered back, the
    conv's halo and the SSD state's carry likewise, the cross-entropy each
    block's own, the router, z and MTP losses the whole sequence's."""
    from torch_parity import (LOSS_RTOL32, assert_grads_close32,
                              port_grad_leaves)
    setup = _train_setup(next(c for c in TRAIN_CASES if c[0] == name))
    loss, grads = _train_split(setup, n)
    want, _, want_grads = setup["ref"]
    assert abs(loss - want) <= LOSS_RTOL32 * abs(want)
    assert_grads_close32(port_grad_leaves(grads), want_grads)


def _shares_grads(n: int, whole, cut, shared, share_fn):
    """Each of ``n`` sequential shares' gradients of its inputs: ``cut``
    (tensors whose dim 1 is the sequence, each share its block) joined in
    rank order, ``shared`` (every share's whole) summed over the shares;
    beside autograd's of the unsplit ``whole(*cut, *shared)``, a scalar.
    ``share_fn(seq, *blocks, *shared)`` is a share's weighted loss."""
    ranks = SequentialRanks(n)
    leaves = [t.clone().requires_grad_(True) for t in cut + shared]
    want = torch.autograd.grad(whole(*leaves), leaves)

    def share(a):
        seq = SeqSplit(a)
        mine = [t.detach().requires_grad_(True)
                for t in [seq.cut(t, 1) for t in cut] + list(shared)]
        return torch.autograd.grad(share_fn(seq, *mine), mine)
    with torch.enable_grad():
        got = ranks.run([lambda a=a: share(a) for a in ranks.axes()])
    parts = list(zip(*got))
    return ([torch.cat(p, 1) for p in parts[:len(cut)]]
            + [sum(p) for p in parts[len(cut):]]), want


@pytest.mark.parametrize("n", SHARES)
def test_kv_gather_sends_each_blocks_gradient_back_to_its_share(n):
    """The fault a plain all-gather of K and V makes in a train step: a
    later share's queries read an earlier share's keys, and that part of
    dK, dV must reach the share that holds the block. ``SeqSplit.gather``
    reduce-scatters the gathered keys' gradient over the data axes: dQ,
    dK and dV of causal attention over ``n`` shares (each block's queries
    at its offset against the gathered keys, plain twin) are autograd's
    of the unsplit attention, within 64 eps of the largest entry. Without
    the reduce-scatter each share keeps only its own queries' part of its
    keys' gradient."""
    rng = np.random.default_rng(13)
    B, S, H, Hkv, D = 1, 12, 4, 2, 8
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32))
                  for shape in ((B, S, H, D), (B, S, Hkv, D),
                                (B, S, Hkv, D), (B, S, H, D)))

    def whole(q, k, v, g):
        return (attention_ref(q, k, v, causal=True) * g).sum()

    def share(seq, q, k, v, g):
        L = q.shape[1]
        lo, hi = seq.block(L)
        kk, vv = seq.gather(torch.stack([k, v]), 2).unbind(0)
        out = attention_ref(q, kk[:, :hi], vv[:, :hi], causal=True,
                            q_offset=lo)
        return (out * g).sum()
    got, want = _shares_grads(n, whole, (q, k, v, g), (), share)
    for a, b in zip(got[:3], want[:3]):
        assert _tight(a, b)


@pytest.mark.parametrize("S,n", [(12, 2), (8, 4)])
def test_conv_halo_sends_the_gradient_to_the_rows_it_came_from(S, n):
    """``SeqSplit.halo``'s backward: the causal conv (``ssm._causal_conv``,
    4 taps) of each share's block with the halo of the 3 raw rows before
    it, and the sequence's last 3 rows (the tail every share holds,
    weighted 1/n a share), give the input, taps and bias the unsplit
    conv's gradients within 64 eps; at 8 positions over 4 shares a block
    of 2 rows takes its halo from two shares below. Its forward under
    autograd is the bits of its forward without it."""
    from repro_torch.models.layers.ssm import _causal_conv
    rng = np.random.default_rng(17)
    K, C = 4, 6
    raw, g = (torch.from_numpy(rng.standard_normal((1, S, C))
                               .astype(np.float32)) for _ in range(2))
    gt = torch.from_numpy(rng.standard_normal((1, K - 1, C))
                          .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, C)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((C,)).astype(np.float32))

    def whole(raw, g, w, b):
        out = _causal_conv(raw, w, b, K)
        return (out * g).sum() + (raw[:, S - (K - 1):] * gt).sum()

    def share(seq, raw, g, w, b):
        halo, tail = seq.halo(raw, K - 1)
        with torch.no_grad():
            assert torch.equal(seq.halo(raw, K - 1)[0], halo)
        out = _causal_conv(raw, w, b, K, halo)
        return (out * g).sum() + (tail * gt).sum() / seq.n
    got, want = _shares_grads(n, whole, (raw, g), (w, b), share)
    for a, c in zip(got, want):
        assert _tight(a, c)


@pytest.mark.parametrize("n", SHARES)
def test_ssd_carry_sends_the_state_gradient_to_the_shares_below(n):
    """``SeqSplit.ssd_carry``'s backward: each share's block scanned from
    a zero state (``ssd_scan_ref``, chunk 4; 2 heads of 3 over 1 group,
    one head masked), the blocks' states and log-decays folded in rank
    order, and the whole sequence's final state (every share's, weighted
    1/n) give x, dt, A, B and C the unsplit scan's gradients within 64
    eps of the largest entry. Rank 0, whose block takes no state, still
    joins the backward's reduce-scatter; its forward under autograd is
    the bits of its forward without it."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    rng = np.random.default_rng(19)
    B, S, H, G, P, N, chunk = 1, 16, 2, 1, 3, 4, 4
    mask = torch.tensor([1.0, 0.0])

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    x, Bm, Cm, gy = f32(B, S, H, P), f32(B, S, G, N), f32(B, S, G, N), \
        f32(B, S, H, P)
    dt = torch.from_numpy(rng.uniform(0.1, 0.6, (B, S, H))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 1.5, (H,)).astype(np.float32))
    gs = f32(B, H, P, N)

    def whole(x, dt, Bm, Cm, gy, A):
        y, state = ssd_scan_ref(x, dt, A, Bm, Cm, mask, chunk)
        return (y * gy).sum() + (state * gs).sum()

    def share(seq, x, dt, Bm, Cm, gy, A):
        y, state = ssd_scan_ref(x, dt, A, Bm, Cm, mask, chunk)
        Ch = Cm.repeat_interleave(H // G, dim=2)
        y2, h = seq.ssd_carry(y, state, dt, A, Ch, mask)
        with torch.no_grad():
            y0, h0 = seq.ssd_carry(y, state, dt, A, Ch, mask)
        assert torch.equal(y0, y2) and torch.equal(h0, h)
        return (y2 * gy).sum() + (h * gs).sum() / seq.n
    got, want = _shares_grads(n, whole, (x, dt, Bm, Cm, gy), (A,),
                               share)
    for a, c in zip(got, want):
        assert _tight(a, c)
