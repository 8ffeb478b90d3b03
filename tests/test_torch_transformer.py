"""The port's transformer serving path (``repro_torch.models
.transformer``, ``repro_torch.launch.steps``) against the reference on the
same numpy parameters and tokens, at the smoke size: the dense families
(2 layers, d_model 256, 4 query / 2 KV heads, d_ff 512, vocab 512), Mamba2
(2 SSD layers of 16 heads of 32, d_state 32, chunk 32) and the Zamba2
hybrid (the same Mamba2 layers with the shared attention + GELU-MLP block
after every layer, and a variant of 3 layers with period 2, whose third
layer is an ungrouped tail).

The reference runs twice: with its Pallas kernels in interpret mode
(``dispatch.use_pallas(interpret=True)``: rmsnorm, flash attention, the
masked FFN GEMMs and the SSD scan) and with dispatch off (its XLA path).
On the CPU every wrapper of the port runs its plain version.

Tolerances: fp32 logits within 64 eps of the largest logit (the same math
in other summation orders; measured under 10 eps); bf16 logits within 4
bf16 spacings (2**-5) of the largest logit — bf16 rounds at different
points in XLA and PyTorch, and the reference's own Pallas and XLA paths
differ by about 1 spacing of it here (measured 0.037 at max 3.78). The
Mamba2 layers' conv windows and float32 SSD states in the cache are held
the same way relative to their own largest entry; in a bf16 model the
state also gets twice the spread between the reference's own two paths
(see ``test_ssm_prefill_then_decode_matches_reference``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core.pruning import masks as rmasks
from repro.kernels import dispatch
from repro.models import transformer as rtr
from repro_torch.configs import registry as treg
from repro_torch.core.pruning import masks as tmasks
from repro_torch.interop import (transformer_masks_from_reference,
                                 transformer_params_from_reference,
                                 transformer_params_to_reference)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttr
from torch_parity import (BF16_SPACING, EPS32, model_batch_np, to_f32,
                          transformer_params_np)
from torch_parity import one_thread  # noqa: F401 (autouse)

#: configs a refusal case pinned, each built from a registry module's smoke
#: configs (``reg``: the reference's or the port's): an MoE stack whose
#: first layer is dense (DeepSeek-V3's ``attn_dense`` run), a dense stack
#: with MLA attention (DeepSeek-V3's MLA shape), one with an MTP head, a
#: bidirectional stack over frame embeddings (audio) and one with a vision
#: prefix and M-RoPE (vlm, its sections those of the smoke Qwen2-VL)
UNPORTED = {
    "moe_dense_layers": lambda reg: reg.get_smoke_config(
        "mixtral-8x7b").replace(num_dense_layers=1),
    "mla": lambda reg: reg.get_smoke_config("qwen2-7b").replace(
        attention="mla",
        mla=reg.get_smoke_config("deepseek-v3-671b").mla),
    "audio": lambda reg: reg.get_smoke_config("qwen2-7b").replace(
        arch_type="audio", embeds_input=True, causal=False),
    "vlm": lambda reg: reg.get_smoke_config("qwen2-7b").replace(
        arch_type="vlm", vision_tokens=16, rope_mode="mrope",
        mrope_sections=(8, 12, 12)),
    "mtp": lambda reg: reg.get_smoke_config("qwen2-7b").replace(mtp_depth=1),
}
DENSE = ["qwen2-7b", "qwen1.5-4b", "gemma-7b", "nemotron-4-340b"]
#: the SSM and hybrid smoke configs: (registry id, overrides)
SSM = {"mamba2": ("mamba2-2.7b", {}),
       "zamba2": ("zamba2-1.2b", {}),
       "zamba2_tail": ("zamba2-1.2b", {"num_layers": 3,
                                       "shared_attn_period": 2})}


def _tol(want: np.ndarray, dtype: str) -> float:
    big = max(1.0, float(np.abs(want).max()))
    return (64 * EPS32 if dtype == "float32" else 4 * BF16_SPACING) * big


def _setup(arch="qwen2-7b", dtype="float32", seed=0, masked=True,
           **overrides):
    """``arch`` a registry id, or a key of ``UNPORTED``."""
    if arch in UNPORTED:
        cr, ct = (UNPORTED[arch](reg) for reg in (rreg, treg))
    else:
        cr, ct = (reg.get_smoke_config(arch) for reg in (rreg, treg))
    cr = cr.replace(dtype=dtype, **overrides)
    ct = ct.replace(dtype=dtype, **overrides)
    pn = transformer_params_np(cr, seed)
    pj = jax.tree_util.tree_map(jnp.asarray, pn)
    pt = transformer_params_from_reference(pn)
    mj = mt = None
    if masked:
        n = len(rmasks.transformer_prunable_units(cr))
        ratios = list(np.random.default_rng(seed + 1).uniform(0.3, 0.8, n))
        mj = rmasks.transformer_masks_from_ratios(pj, cr, ratios)
        mt = transformer_masks_from_reference(mj)
    return cr, ct, pj, pt, mj, mt


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _both_reference_paths(fn):
    """fn() with the reference's Pallas kernels (interpret) and without."""
    with dispatch.use_pallas(interpret=True):
        on = fn()
    return on, fn()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, masked):
    cr, ct, pj, pt, mj, mt = _setup(dtype=dtype, masked=masked)
    tok = _tokens(cr, 2, 20)
    got, aux = ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)
    assert got.shape == (2, 20, ct.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    got = to_f32(got)
    for want in _both_reference_paths(lambda: to_f32(rtr.forward(
            pj, cr, {"tokens": jnp.asarray(tok)}, mj)[0])):
        assert np.abs(got - want).max() <= _tol(want, dtype)


@pytest.mark.parametrize("arch", DENSE[1:])
def test_dense_families_forward_match_reference(arch):
    """GeGLU with scaled embeddings (gemma), MHA (qwen1.5), squared-ReLU
    without a gate (nemotron), all with pruning masks."""
    cr, ct, pj, pt, mj, mt = _setup(arch)
    tok = _tokens(cr, 2, 12)
    got = ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)[0]
    with dispatch.use_pallas(interpret=True):
        want = to_f32(rtr.forward(pj, cr, {"tokens": jnp.asarray(tok)},
                                  mj)[0])
    assert np.abs(to_f32(got) - want).max() <= _tol(want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """Prefill S - 3 tokens, then 3 decode steps through the steps a
    server calls, against the reference's prefill and decode_step; each
    logit row also equals the port's own full forward (cache
    consistency)."""
    cr, ct, pj, pt, mj, mt = _setup(dtype=dtype)
    B, S, n_dec = 2, 16, 3
    tok = _tokens(cr, B, S, seed=3)
    max_len = S + 4

    def reference():
        lg, cache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(
            tok[:, :S - n_dec])}, max_len=max_len, masks=mj)
        outs = [to_f32(lg)]
        for t in range(S - n_dec, S):
            lg, cache = rtr.decode_step(pj, cr, cache,
                                        jnp.asarray(tok[:, t:t + 1]), mj)
            outs.append(to_f32(lg))
        return np.stack(outs, 1)

    prefill = make_prefill_step(ct, max_len=max_len, masks=mt, device="cpu")
    decode = make_decode_step(ct, masks=mt, device="cpu")
    lg, cache = prefill(pt, {"tokens": tok[:, :S - n_dec]})
    assert cache["runs"][0].k.shape == (ct.num_layers, B, max_len,
                                        ct.num_kv_heads, ct.head_dim)
    outs = [to_f32(lg)]
    for t in range(S - n_dec, S):
        lg, cache = decode(pt, cache, tok[:, t:t + 1])
        outs.append(to_f32(lg))
    got = np.stack(outs, 1)
    assert cache["pos"].tolist() == [S] * B
    for want in _both_reference_paths(reference):
        assert np.abs(got - want).max() <= _tol(want, dtype)
    full = to_f32(ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)},
                              mt)[0])[:, S - n_dec - 1:]
    assert np.abs(got - full).max() <= _tol(full, dtype)


@pytest.mark.parametrize("n_prefill", [4, 12])
def test_sliding_window_rolling_cache(n_prefill):
    """window 8, 24 tokens: the prefill cache is padded (4 tokens) or
    rolled (12 tokens, past the window), then decode walks far past the
    window in the rolling buffer; every step equals the reference's
    and the port's full forward."""
    cr, ct, pj, pt, mj, mt = _setup(sliding_window=8)
    S = 24
    tok = _tokens(cr, 1, S, seed=4)
    lg, cache = ttr.prefill(pt, ct, {"tokens": torch.from_numpy(
        tok[:, :n_prefill])}, max_len=S, masks=mt)
    rlg, rcache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(
        tok[:, :n_prefill])}, max_len=S, masks=mj)
    assert cache["runs"][0].k.shape[2] == 8
    np.testing.assert_allclose(to_f32(cache["runs"][0].k),
                               to_f32(rcache["runs"][0].k), rtol=0,
                               atol=_tol(to_f32(rcache["runs"][0].k),
                                         "float32"))
    full = to_f32(ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)},
                              mt)[0])
    for t in range(n_prefill, S):
        lg, cache = ttr.decode_step(pt, ct, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), mt)
        rlg, rcache = rtr.decode_step(pj, cr, rcache,
                                      jnp.asarray(tok[:, t:t + 1]), mj)
        want = to_f32(rlg)
        assert np.abs(to_f32(lg) - want).max() <= _tol(want, "float32")
    assert np.abs(to_f32(lg) - full[:, -1]).max() <= _tol(full, "float32")


def test_prefill_rejects_short_max_len():
    cr, ct, pj, pt, mj, mt = _setup(masked=False)
    with pytest.raises(ValueError, match="max_len"):
        ttr.prefill(pt, ct, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
                    max_len=4)


def test_steps_serve_greedy_on_the_cpu_without_a_launch():
    """A server's loop: prefill, then greedy decode, through the steps;
    on the CPU no kernel is launched, and the stack's plain backend gives
    the same tokens bit for bit."""
    cr, ct, pj, pt, mj, mt = _setup(dtype="bfloat16")
    counts = (rmsnorm.launches, flash_attention.launches,
              masked_matmul.launches)
    tok = torch.from_numpy(_tokens(cr, 2, 10, seed=5))
    steps = {"auto": (make_prefill_step(ct, max_len=14, masks=mt,
                                        device="cpu"),
                      make_decode_step(ct, masks=mt, device="cpu")),
             "ref": (lambda p, batch: ttr.prefill(
                         p, ct, batch, max_len=14, masks=mt, backend="ref"),
                     lambda p, cache, t: ttr.decode_step(
                         p, ct, cache, t, masks=mt, backend="ref"))}
    runs = {}
    for backend, (prefill, decode) in steps.items():
        lg, cache = prefill(pt, {"tokens": tok})
        toks, logits = [], [lg]
        for _ in range(4):
            nxt = lg.argmax(-1, keepdim=True)
            toks.append(nxt)
            lg, cache = decode(pt, cache, nxt)
            logits.append(lg)
        runs[backend] = (torch.cat(toks, 1), torch.stack(logits, 1))
    assert torch.equal(runs["auto"][0], runs["ref"][0])
    assert torch.equal(runs["auto"][1], runs["ref"][1])
    assert counts == (rmsnorm.launches, flash_attention.launches,
                      masked_matmul.launches)
    with pytest.raises(ValueError, match="backend"):
        ttr.forward(pt, ct, {"tokens": torch.zeros((1, 2), dtype=torch.long)},
                    backend="pallas")


def test_bf16_params_round_trip_bit_for_bit():
    cr, ct, pj, pt, mj, mt = _setup(dtype="bfloat16", masked=False)
    back = transformer_params_to_reference(pt)
    flat_r, tree_r = jax.tree_util.tree_flatten(pj)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_r == tree_b
    for a, b in zip(flat_r, flat_b):
        a = np.asarray(a)
        assert b.dtype == a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    assert pt["runs"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_init_params_has_the_reference_layout():
    cfg = treg.get_smoke_config("qwen2-7b")
    ref = jax.eval_shape(lambda: rtr.init_params(
        rreg.get_smoke_config("qwen2-7b"), jax.random.PRNGKey(0)))
    got = ttr.init_params(cfg, seed=0, device="cpu")
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_r == tree_g
    for r, g in zip(flat_r, flat_g):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(r.dtype) == str(g.dtype).removeprefix("torch.")
    assert ttr.param_count(got) == sum(x.size for x in flat_r)
    again = ttr.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(got["runs"][0]["mlp"]["w_up"],
                       again["runs"][0]["mlp"]["w_up"])


#: sha256 of the smoke trees ``init_params`` drew at seed 0 on the CPU
#: before it drew each tensor into its slot of the stacked run tensor
#: (``_tree_digest``): the same draws in the same order, bit for bit
INIT_DIGESTS = {
    "qwen2-7b":
        "e54ea2ed3ea2da8015b1742f22b58fec7c0a73af539e3a101b0848ad7aead0b7",
    "mixtral-8x7b":
        "1ec6a39a462c24399f025533a5c655ebc577bfc981c58a7a5f3d4739752cec8d",
    "mamba2-2.7b":
        "bc4893d2cfade7262e1badbc2a8d7cbfd7097418ca46ff6287956adc20b6cdcf",
    "zamba2-1.2b":
        "3c511cc17013cad6d6a2d975c89a4d96311ca105df35d5d1bf05b5dd0da41b30",
}


def _tree_digest(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, in sorted
    key order."""
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            h.update("/".join(path).encode())
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_init_params_keeps_its_numbers(arch):
    """Drawing each weight straight into its stacked slot (scaled in
    place, cast on the copy) keeps every existing config's weights: the
    smoke Qwen2, Mixtral, Mamba2 and Zamba2 trees hash as they did when
    each layer's tree was built and then stacked."""
    got = ttr.init_params(treg.get_smoke_config(arch), seed=0, device="cpu")
    assert _tree_digest(got) == INIT_DIGESTS[arch]


@pytest.mark.parametrize("arch", sorted(treg.ARCH_IDS))
def test_configs_equal_reference(arch):
    assert treg.ARCH_IDS == rreg.ARCH_IDS
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(treg, get)(arch))
                == dataclasses.asdict(getattr(rreg, get)(arch)))


#: configs a refusal case once pinned, served since: each keeps its case
#: and holds the entry points against the reference (the MoE family's
#: registry config, the three shapes the MLA slice brought, and the audio
#: and vision families)
SERVED = ("mixtral-8x7b", "moe_dense_layers", "mla", "mtp", "audio", "vlm")


def _served_config_matches_reference(arch):
    """The four entry points the refusal case called: ``init_params`` has
    the reference's layout, ``init_cache`` the layout ``prefill`` fills,
    and the steps serve a prefill and two decode steps with the
    reference's logits (its XLA path; ``tests/test_torch_moe.py``,
    ``tests/test_torch_mla.py``, ``tests/test_torch_audio.py`` and
    ``tests/test_torch_vlm.py`` hold both paths). A VLM config's prefill
    puts its vision embeddings before the 8 tokens (and its cache holds
    them too). A bidirectional config's prefill gives every position's
    logits and no cache, its ``init_cache`` has the reference's layout,
    and ``make_decode_step`` refuses it."""
    cr, ct, pj, pt, mj, mt = _setup(arch)
    ref = jax.eval_shape(lambda: rtr.init_params(cr, jax.random.PRNGKey(0)))
    got = ttr.init_params(ct, seed=0, device="cpu")
    assert (jax.tree_util.tree_structure(ref)
            == jax.tree_util.tree_structure(got))
    batch = model_batch_np(cr, 2, 10, seed=6)
    pre = {k: (v[:, :8] if k in ("tokens", "embeds") else v)
           for k, v in batch.items()}
    max_len = 12 + cr.vision_tokens
    prefill = make_prefill_step(ct, max_len=max_len, masks=mt, device="cpu")
    lg, cache = prefill(pt, pre)
    rlg, rcache = rtr.prefill(pj, cr, {k: jnp.asarray(v)
                                       for k, v in pre.items()},
                              max_len=max_len, masks=mj)
    empty = ttr.init_cache(ct, 2, max_len, device="cpu")
    if not ct.causal:
        assert cache is None is rcache
        want = to_f32(rlg)
        assert lg.shape == (2, 8, ct.vocab_size)
        assert np.abs(to_f32(lg) - want).max() <= _tol(want, "float32")
        rempty = jax.eval_shape(lambda: rtr.init_cache(cr, 2, max_len))
        assert [tuple(t.shape) for run in empty["runs"] for t in run] == \
            [tuple(t.shape) for run in rempty["runs"] for t in run]
        with pytest.raises(ValueError, match="no decode step"):
            make_decode_step(ct, masks=mt, device="cpu")
        return
    decode = make_decode_step(ct, masks=mt, device="cpu")
    for run_e, run_c in zip(empty["runs"], cache["runs"]):
        assert type(run_e) is type(run_c)
        assert [tuple(t.shape) for t in run_e] == \
            [tuple(t.shape) for t in run_c]
    tok = batch["tokens"]
    for t in (8, 9):
        want = to_f32(rlg)
        assert np.abs(to_f32(lg) - want).max() <= _tol(want, "float32")
        lg, cache = decode(pt, cache, tok[:, t:t + 1])
        rlg, rcache = rtr.decode_step(pj, cr, rcache,
                                      jnp.asarray(tok[:, t:t + 1]), mj)
    want = to_f32(rlg)
    assert np.abs(to_f32(lg) - want).max() <= _tol(want, "float32")


@pytest.mark.parametrize("arch", sorted(UNPORTED) + ["mixtral-8x7b"])
def test_unported_configs_raise(arch):
    """Every config a refusal case pinned is served now (``SERVED``)."""
    assert arch in SERVED
    _served_config_matches_reference(arch)


# ---------------------------------------------------------------------------
# Mamba2 (ssm) and Zamba2 (hybrid) stacks
# ---------------------------------------------------------------------------
def _ssm_setup(variant, dtype="float32", seed=0, masked=True):
    arch, overrides = SSM[variant]
    return _setup(arch, dtype, seed, masked, **overrides)


def _ref_ssm_cache(cfg, rc):
    """The reference's cache of an ssm run -> (conv, state) stacked flat
    over the run's layers, as numpy: a hybrid's is ((groups, period, ...),
    tail)."""
    if not cfg.shared_attn_period:
        return to_f32(rc.conv), to_f32(rc.state)
    parts = [p for p in rc if p is not None]
    return tuple(np.concatenate(
        [to_f32(getattr(p, f)).reshape((-1,) + getattr(p, f).shape[-4 + (
            f == "conv"):]) for p in parts]) for f in ("conv", "state"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(SSM))
def test_ssm_forward_matches_reference(variant, dtype):
    """SSD head masks from the reference's ``transformer_masks_from_ratios``
    on every layer (the shared block is not pruned)."""
    cr, ct, pj, pt, mj, mt = _ssm_setup(variant, dtype)
    tok = _tokens(cr, 2, 40)
    got, aux = ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)}, mt)
    assert got.shape == (2, 40, ct.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    got = to_f32(got)
    for want in _both_reference_paths(lambda: to_f32(rtr.forward(
            pj, cr, {"tokens": jnp.asarray(tok)}, mj)[0])):
        assert np.abs(got - want).max() <= _tol(want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(SSM))
def test_ssm_prefill_then_decode_matches_reference(variant, dtype):
    """Prefill S - 3 tokens (S - 3 = 34: a ragged chunk), then 3 decode
    steps through the steps a server calls, against the reference's
    prefill and decode_step: the logits, and the SSD states and conv
    windows each Mamba2 layer hands on, after prefill and after decode;
    each logit row also equals the port's own full forward."""
    cr, ct, pj, pt, mj, mt = _ssm_setup(variant, dtype, seed=1)
    B, S, n_dec = 2, 37, 3
    tok = _tokens(cr, B, S, seed=3)
    max_len = S + 4
    snaps = {}

    def reference():
        lg, cache = rtr.prefill(pj, cr, {"tokens": jnp.asarray(
            tok[:, :S - n_dec])}, max_len=max_len, masks=mj)
        snaps.setdefault("prefill", []).append(
            _ref_ssm_cache(cr, cache["runs"][0]))
        outs = [to_f32(lg)]
        for t in range(S - n_dec, S):
            lg, cache = rtr.decode_step(pj, cr, cache,
                                        jnp.asarray(tok[:, t:t + 1]), mj)
            outs.append(to_f32(lg))
        snaps.setdefault("decode", []).append(
            _ref_ssm_cache(cr, cache["runs"][0]))
        if cr.shared_attn_period:
            snaps.setdefault("shared", []).append(to_f32(cache["shared"].k))
        return np.stack(outs, 1)

    prefill = make_prefill_step(ct, max_len=max_len, masks=mt, device="cpu")
    decode = make_decode_step(ct, masks=mt, device="cpu")
    lg, cache = prefill(pt, {"tokens": tok[:, :S - n_dec]})
    # copies: decode updates the cache's tensors in place
    got_snaps = {"prefill": (to_f32(cache["runs"][0].conv).copy(),
                             to_f32(cache["runs"][0].state).copy())}
    outs = [to_f32(lg)]
    for t in range(S - n_dec, S):
        lg, cache = decode(pt, cache, tok[:, t:t + 1])
        outs.append(to_f32(lg))
    got_snaps["decode"] = (to_f32(cache["runs"][0].conv),
                           to_f32(cache["runs"][0].state))
    got = np.stack(outs, 1)
    assert cache["pos"].tolist() == [S] * B
    L, H = ct.num_layers, ct.ssm_heads
    assert got_snaps["decode"][1].shape == (L, B, H, ct.ssm.head_dim,
                                            ct.ssm.d_state)
    for i, want in enumerate(_both_reference_paths(reference)):
        assert np.abs(got - want).max() <= _tol(want, dtype)
        for when in ("prefill", "decode"):
            for g, w, w2 in zip(got_snaps[when], *snaps[when]):
                assert g.shape == w.shape
                # a bf16 model's state is a float32 sum of bf16-rounded
                # terms with no norm after it: one rounding of dt's input
                # moves it further than the logits (the reference's own
                # two paths differ by up to 1.5 spacings of it after the
                # hybrid's shared block), so bf16 also allows twice the
                # reference's own spread
                spread = 2 * np.abs(w - w2).max() if dtype != "float32" \
                    else 0.0
                assert np.abs(g - w).max() <= _tol(w, dtype) + spread
        if cr.shared_attn_period:
            w = snaps["shared"][i]
            assert cache["shared"].k.shape == w.shape
            assert np.abs(to_f32(cache["shared"].k) - w).max() <= _tol(
                w, dtype)
    full = to_f32(ttr.forward(pt, ct, {"tokens": torch.from_numpy(tok)},
                              mt)[0])[:, S - n_dec - 1:]
    assert np.abs(got - full).max() <= _tol(full, dtype)


@pytest.mark.parametrize("variant", sorted(SSM))
def test_ssm_steps_serve_greedy_on_the_cpu_without_a_launch(variant):
    """A server's loop over the Mamba2 or hybrid stack: prefill, then
    greedy decode; on the CPU no kernel is launched, and the stack's plain
    backend gives the same tokens and logits bit for bit."""
    cr, ct, pj, pt, mj, mt = _ssm_setup(variant, "bfloat16", seed=2)
    wrappers = (rmsnorm, flash_attention, masked_matmul, ssd_scan)
    counts = [w.launches for w in wrappers]
    tok = torch.from_numpy(_tokens(cr, 2, 10, seed=5))
    runs = {}
    for backend in ("auto", "ref"):
        lg, cache = ttr.prefill(pt, ct, {"tokens": tok}, max_len=14,
                                masks=mt, backend=backend)
        toks, logits = [], [lg]
        for _ in range(4):
            nxt = lg.argmax(-1, keepdim=True)
            toks.append(nxt)
            lg, cache = ttr.decode_step(pt, ct, cache, nxt, masks=mt,
                                        backend=backend)
            logits.append(lg)
        runs[backend] = (torch.cat(toks, 1), torch.stack(logits, 1))
    assert torch.equal(runs["auto"][0], runs["ref"][0])
    assert torch.equal(runs["auto"][1], runs["ref"][1])
    assert counts == [w.launches for w in wrappers]


@pytest.mark.parametrize("variant", sorted(SSM))
def test_ssm_init_params_and_cache_have_the_reference_layout(variant):
    """``init_params``: the reference's tree, shapes and dtypes (float32
    A_log, dt_bias and D in a bf16 model; the hybrid's ``shared`` block);
    ``init_cache``: the layout ``prefill`` returns."""
    arch, overrides = SSM[variant]
    cfg = treg.get_smoke_config(arch).replace(**overrides)
    ref = jax.eval_shape(lambda: rtr.init_params(
        rreg.get_smoke_config(arch).replace(**overrides),
        jax.random.PRNGKey(0)))
    got = ttr.init_params(cfg, seed=0, device="cpu")
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_r == tree_g
    for r, g in zip(flat_r, flat_g):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(r.dtype) == str(g.dtype).removeprefix("torch.")
    assert got["runs"][0]["ssm"]["A_log"].dtype == torch.float32
    assert ("shared" in got) == bool(cfg.shared_attn_period)
    cache = ttr.init_cache(cfg, 2, 12, device="cpu")
    _, filled = ttr.prefill(got, cfg, {"tokens": torch.zeros(
        (2, 5), dtype=torch.long)}, max_len=12)
    flat_c, tree_c = jax.tree_util.tree_flatten(cache)
    flat_f, tree_f = jax.tree_util.tree_flatten(filled)
    assert tree_c == tree_f
    for c, f in zip(flat_c, flat_f):
        assert c.shape == f.shape and c.dtype == f.dtype
