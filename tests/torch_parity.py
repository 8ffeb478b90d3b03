"""Shared inputs for the ``test_torch_*`` parity tests: one set of numpy
arrays, made from a seed, handed to both the JAX reference (``repro``)
and the PyTorch port (``repro_torch``). Never a ``jax.random`` key: the
reference's PRNG stream moved between JAX versions."""
from __future__ import annotations

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as rcnn
from repro_torch.data.requests import request_batch
from repro_torch.interop import params_from_reference
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import cnn as tcnn

#: fp32 float epsilon (unit roundoff is half of it)
EPS32 = float(np.finfo(np.float32).eps)
#: bf16 keeps 8 significant bits: neighbouring values of magnitude v lie at
#: most 2**-7 * |v| apart, so two roundings of nearby fp32 values to bf16
#: differ by at most their fp32 gap plus that much
BF16_SPACING = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a port test module's work, restored after.
    The suite runs six workers on the host's cores, and a worker's
    default of a thread a core made small ops wait on each other: the
    DDPG search test took 119 s alone at 8 threads and 2.9 s at one, and
    466 s under the suite's load. A module takes it by importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_f32(x) -> np.ndarray:
    """A torch tensor or a (JAX / numpy, any float dtype) array as a
    float32 numpy array."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x).astype(np.float32)


def tiny_setup(seed: int = 0, batch: int = 2):
    """(cfg_ref, cfg_port, params_np, masks_np, x_np) at the tests' small
    size: ``tiny_cnn_config(num_classes=7, hw=32)``, He-normal weights and
    small random biases (so bias-add paths are exercised), masks that keep
    exactly half of each prunable layer's channels."""
    cfg_r = rcnn.tiny_cnn_config(num_classes=7, hw=32)
    cfg_t = tcnn.tiny_cnn_config(num_classes=7, hw=32)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shp in tcnn.param_shapes(cfg_t).items():
        fan_in = int(np.prod(shp["w"][:-1]))
        params[name] = {
            "w": (rng.standard_normal(shp["w"], dtype=np.float32)
                  * np.float32(np.sqrt(2.0 / fan_in))),
            "b": rng.standard_normal(shp["b"], dtype=np.float32) * 0.1}
    masks = {}
    for i in tcnn.prunable_layers(cfg_t):
        n = params[f"l{i}"]["b"].shape[0]
        m = np.zeros(n, np.float32)
        m[rng.permutation(n)[:n // 2]] = 1.0
        masks[i] = m
    x = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
    return cfg_r, cfg_t, params, masks, x


def cnn_configs(name: str, seed: int = 3):
    """(cfg_ref, cfg_port, masks_np) of ``"tiny"`` (``tiny_setup``'s) or
    ``"alexnet"`` (``alexnet_config(38)`` at full width, masks keeping a
    random half of each prunable layer's channels), for tests where only
    arithmetic runs at full width."""
    if name == "tiny":
        cfg_r, cfg_t, _, masks, _ = tiny_setup()
        return cfg_r, cfg_t, masks
    cfg_t = tcnn.alexnet_config(38)
    rng = np.random.default_rng(seed)
    masks = {}
    for i in tcnn.prunable_layers(cfg_t):
        n = tcnn.param_shapes(cfg_t)[f"l{i}"]["b"][0]
        m = np.zeros(n, np.float32)
        m[rng.permutation(n)[:n // 2]] = 1.0
        masks[i] = m
    return rcnn.alexnet_config(38), cfg_t, masks


def ref_tree(params_np):
    """numpy params -> the reference's tree of JAX arrays."""
    return {k: {n: jnp.asarray(a) for n, a in v.items()}
            for k, v in params_np.items()}


def port_params(params_np):
    """numpy params -> the port's dict of CPU tensors."""
    return params_from_reference(params_np)


def port_masks(masks_np):
    return {i: torch.from_numpy(m) for i, m in masks_np.items()}


def fp32_tol(ref: np.ndarray) -> float:
    """Absolute tolerance for two fp32 evaluations of the same small CNN
    that sum in different orders (XLA's conv and GEMM against oneDNN's and
    MKL's): 64 eps relative to the tensor's largest entry. The measured
    gap at this size is under 4 eps; the margin covers the ~sqrt(K)·eps
    growth of other reduction orders over K <= 2304 and the few layers it
    compounds through, and is still far below what a wrong index or
    layout would give."""
    return 64 * EPS32 * max(1.0, float(np.max(np.abs(ref))))


def codec_bound(bank, split: int, image: np.ndarray) -> np.ndarray:
    """Elementwise bound on the logit gap one int8 codec step at the
    split can cause, for a port ``SplitFnBank``: the two packages' edge
    outputs differ by fp32 rounding, so a code may land one step apart
    (step = the frame's scale); ``cnn_abs_bound`` carries a one-step
    perturbation of every element through the cloud half. ``image`` is
    one request (1, H, W, C) or the requests of one fused frame (n, H, W,
    C), whose rows share the frame's scale."""
    from repro_torch.core.collab.protocol import affine_qparams
    edge, _, _ = bank.get(split)
    with torch.no_grad():
        feats = [edge(torch.from_numpy(row[None])) if edge else
                 torch.from_numpy(row[None]) for row in image]
    scale, _ = affine_qparams(min(float(f.min()) for f in feats),
                              max(float(f.max()) for f in feats), 255)
    delta = torch.full_like(feats[0], scale)
    with torch.no_grad():
        return tcnn.cnn_abs_bound(bank._tparams, bank.deploy_cfg, delta,
                                  masks=bank._masks,
                                  start_layer=split).numpy()


def transformer_params_np(cfg, seed: int = 0):
    """A parameter tree of numpy arrays in the reference transformer's
    layout for ``cfg`` (shapes and dtypes from ``jax.eval_shape`` of its
    ``init_params``: ``cfg.dtype``, except the Mamba2 block's float32
    ``A_log``, ``dt_bias`` and ``D``): weights normal / sqrt(fan_in),
    embeddings normal x 0.02, and — unlike the reference's zeros and ones —
    random QKV and conv biases, norm scales near 1 (MLA's latent norms
    and the MTP head's too) and skip weights ``D``
    near 1, so the bias, scale and skip paths carry real numbers. The SSD
    decay parameters are drawn in the reference's ranges, per head:
    ``A_log = log(A)`` with A uniform in [1, 16], ``dt_bias`` the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1]."""
    import jax
    from repro.models import transformer as rtr
    shapes = jax.eval_shape(lambda: rtr.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        shp = sd.shape
        if name in ("ln1", "ln2", "final_norm", "norm_scale", "D", "ln",
                    "q_norm", "kv_norm"):
            a = 1.0 + 0.1 * rng.standard_normal(shp)
        elif name in ("bq", "bk", "bv", "conv_b"):
            a = 0.1 * rng.standard_normal(shp)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(shp)
        elif name == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, shp))
        elif name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shp))
            a = dt + np.log(-np.expm1(-dt))
        else:   # (count, fan_in, fan_out) stacked, or (fan_in, fan_out)
            a = rng.standard_normal(shp) / np.sqrt(shp[-2])
        return np.asarray(a.astype(np.float32)).astype(sd.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def model_batch_np(cfg, B: int, S: int, seed: int = 2):
    """A request batch of numpy arrays for ``cfg`` from ``seed``
    (``repro_torch.data.requests.request_batch``): an audio config's S
    frame embeddings, else S tokens after a VLM config's vision prefix,
    with no M-RoPE ids (the stack's text positions)."""
    return request_batch(cfg, B, S + (cfg.vision_tokens or 0),
                         np.random.default_rng(seed), grid=False)


def stack_tol(want: np.ndarray, dtype: str) -> float:
    """The transformer stacks' tolerance: float32 within 64 eps of the
    largest entry (the same math in other summation orders), bf16 within
    4 bf16 spacings of it."""
    big = max(1.0, float(np.abs(want).max()))
    return (64 * EPS32 if dtype == "float32" else 4 * BF16_SPACING) * big


def both_reference_paths(fn):
    """fn() with the reference's Pallas kernels (interpret) and without."""
    from repro.kernels import dispatch
    with dispatch.use_pallas(interpret=True):
        on = fn()
    return on, fn()


def assert_rows_close(got, on, off, dtype):
    """``got`` within ``stack_tol`` of each reference path (``on``: its
    Pallas kernels in interpret mode, ``off``: its XLA path), row by row (a
    row is one position's logits). In bf16 a row may also differ by twice
    the reference's own two paths' gap on that row: rounding at other
    points can move a token's router scores across the top-k boundary,
    which routes it to another expert, and the reference's two paths do so
    themselves (the unmasked smoke Mixtral forward: a gap of 1.82 between
    them at 2 of its 160 rows, where the port's largest gap to the Pallas
    path is 0.047)."""
    spread = (0.0 if dtype == "float32"
              else 2 * np.abs(on - off).max(-1, keepdims=True))
    for want in (on, off):
        assert (np.abs(got - want) <= stack_tol(want, dtype) + spread).all()


def ssd_inputs(B, S, H, G, P, N, dtype="float32", seed=0):
    """Inputs of the SSD scan as the Mamba2 block gives them, as numpy
    arrays: x, B and C normal (in ``dtype``); dt = softplus(u + dt_bias)
    with u normal and dt_bias the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1] per head; A = -linspace(1, 16, H) (the reference's init),
    so the fast heads decay by up to e^-16 a step, where ``exp`` above the
    decay matrix's diagonal overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    d0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    bias = d0 + np.log(-np.expm1(-d0))
    u = rng.standard_normal((B, S, H)) + bias
    dt = np.logaddexp(u, 0.0).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt_np = {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (x.astype(dt_np), dt, A, Bm.astype(dt_np), Cm.astype(dt_np))


def ssd_tolerance(xh, dt, A, Bm, Cm, chunk: int):
    """Elementwise bounds (on y, on the final state) between two float32
    evaluations of the chunked SSD scan that sum in other orders, or walk
    other chunk lengths up to ``chunk``.

    Every output is a sum of products of x, B, C, the step sizes and decay
    factors in [0, 1]; the plain version run on |x|, |B|, |C| gives the sum
    of those products' magnitudes, M. A dot product of length n in float32
    errs by at most n·eps/2·M: the lengths here are N (C·B), the chunk Q
    (W·x and the chunk's state), and the number of chunks (the carried
    state). The decay exponents are differences of cumulative sums within
    a chunk, whose rounding is eps·|cs| absolute at most, and a relative
    error of e^x is the absolute error of x: so 2·max|cs|·eps more. Hence
    (N + Q + n_chunks + 2·max|cs|)·eps·M."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    t = [torch.from_numpy(np.asarray(a).astype(np.float32))
         for a in (xh, dt, A, Bm, Cm)]
    S, N = t[0].shape[1], t[3].shape[3]
    Q = max(1, min(chunk, S))
    mag_y, mag_s = ssd_chunked(t[0].abs(), t[1], t[2], t[3].abs(),
                               t[4].abs(), Q)
    nc = -(-S // Q)
    da = torch.nn.functional.pad(t[1] * t[2].abs(), (0, 0, 0, nc * Q - S))
    cs_max = float(da.reshape(da.shape[0], nc, Q, -1).sum(2).max())
    k = (N + Q + nc + 2 * cs_max) * EPS32
    return k * mag_y.numpy(), k * mag_s.numpy()


def p_in_bf16_attention(q, k, v, causal, window):
    """Plain attention as the bf16 kernel rounds it: fp32 scores scaled
    after Q·Kᵀ, NEG_INF masks, fp32 softmax numerator P and denominator l,
    P rounded to bf16 before P·V, the fp32 sum divided by max(l, 1e-37) and
    rounded to bf16 once."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * D ** -0.5
    d = torch.arange(S)[:, None] - torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p16 = p.to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p16 / l.clamp_min(1e-37),
                       v.float())
    return out.reshape(B, S, H, D).to(torch.bfloat16)


def flash_bf16_tolerance(v: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The bf16 flash kernel's stated tolerance: rounding each P entry to
    bf16 moves it by at most 2⁻⁸ of itself, so an output by at most
    2⁻⁸·max|v|; with 64·eps32·max|v| for the fp32 roundoff and one bf16
    spacing of the value."""
    vmax = float(np.abs(v).max())
    fp = (64 * EPS32 + 2.0 ** -8) * vmax
    return fp + BF16_SPACING * (np.abs(want) + fp)


def free_port() -> int:
    """A TCP port the OS assigns on 127.0.0.1 (bind port 0, read it back,
    release it) for a server the test then starts there; the reference's
    socket tests hold fixed ports below the OS's ephemeral range."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# training: loss_fn and its gradients in both packages
# ---------------------------------------------------------------------------
#: fp32 training tolerances: the loss within 1e-5 of the reference's,
#: relative (the same sums in other orders: measured under 1e-6 at the
#: smoke size), and each gradient leaf within 1e-4 of the reference leaf's
#: largest entry (measured under 5e-6 on every family)
LOSS_RTOL32 = 1e-5
GRAD_RTOL32 = 1e-4


def train_batch_np(cfg, B: int, S: int, seed: int = 2):
    """``model_batch_np`` (S text tokens or frames; no M-RoPE ids) plus
    ``labels`` (B, S) int32 in [0, vocab), one of them -1 (masked)."""
    b = model_batch_np(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 1] = -1
    b["labels"] = labels
    return b


def train_setup(arch: str, dtype: str = "float32", masked: bool = True,
                seed: int = 0, **overrides):
    """(cfg_ref, cfg_port, params_np, masks_np or None) of the registry
    smoke config ``arch`` in ``dtype``: ``transformer_params_np``'s tree,
    and masks from ``transformer_masks_from_ratios`` at ratios in [0.3,
    0.8) (the reference's, on its own arrays)."""
    import jax
    from repro.configs import registry as rreg
    from repro.core.pruning import masks as rmasks
    from repro_torch.configs import registry as treg
    cr = rreg.get_smoke_config(arch).replace(dtype=dtype, **overrides)
    ct = treg.get_smoke_config(arch).replace(dtype=dtype, **overrides)
    pn = transformer_params_np(cr, seed)
    mn = None
    if masked:
        n = len(rmasks.transformer_prunable_units(cr))
        ratios = list(np.random.default_rng(seed + 1).uniform(0.3, 0.8, n))
        mn = jax.tree_util.tree_map(np.asarray, rmasks
                                    .transformer_masks_from_ratios(
                                        jax.tree_util.tree_map(
                                            jnp.asarray, pn), cr, ratios))
    return cr, ct, pn, mn


def reference_loss_and_grads(cfg, params_np, batch_np, masks_np=None):
    """(loss, metrics, grad leaves) of the reference's ``loss_fn`` by
    ``jax.value_and_grad`` (its training path: Pallas dispatch off), as
    numpy; the leaves in the tree's flattening order."""
    import jax
    from repro.models import transformer as rtr
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    (loss, metrics), grads = jax.value_and_grad(rtr.loss_fn, has_aux=True)(
        to_j(params_np), cfg, to_j(batch_np),
        None if masks_np is None else to_j(masks_np))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def port_batch(batch_np):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}


def port_loss_and_grads(cfg, params, batch, masks=None, backend="auto"):
    """(loss, metrics as floats, grad tree) of the port's ``loss_fn`` on
    CPU tensors (``launch.steps.loss_and_grads``)."""
    from repro_torch.launch.steps import loss_and_grads
    metrics, grads = loss_and_grads(params, cfg, batch, masks, backend)
    return (metrics["loss"], {k: float(v) for k, v in metrics.items()},
            grads)


def port_grad_leaves(grads):
    """The port's gradient tree as numpy leaves in the reference tree's
    flattening order (``interop``: the same layout)."""
    import jax
    from repro_torch.interop import transformer_params_to_reference
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(
        transformer_params_to_reference(grads))]


def assert_grads_close32(got, want):
    """Each port leaf within ``GRAD_RTOL32`` of the reference leaf's
    largest entry (a leaf the loss never reads is zero in both)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = GRAD_RTOL32 * float(np.abs(w).max())
        assert np.abs(to_f32(g) - to_f32(w)).max() <= tol


def _f32_leaves(tree):
    import jax
    return [to_f32(a) for a in jax.tree_util.tree_leaves(tree)]


def adamw_step_both(arch, batch_np, grad_accum=1, masked=True, lr=1e-3,
                    **overrides):
    """(cfg_ref, params_np, reference (params, state, metrics), port
    (params, state, metrics)) of one AdamW step at ``lr`` through each
    package's ``make_train_step`` from ``train_setup``'s numpy tree (the
    port's on the CPU)."""
    import jax
    from repro.launch import steps as rsteps
    from repro.optim import adamw as radamw
    from repro.optim import constant as rconstant
    from repro_torch.interop import (transformer_masks_from_reference,
                                     transformer_params_from_reference)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    cr, ct, pn, mn = train_setup(arch, masked=masked, **overrides)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    ropt = radamw(rconstant(lr))
    rp = to_j(pn)
    ref = rsteps.make_train_step(cr, ropt, None if mn is None else to_j(mn),
                                 grad_accum)(rp, ropt.init(rp),
                                             to_j(batch_np))
    topt = adamw(constant(lr))
    tp = transformer_params_from_reference(pn)
    port = make_train_step(ct, topt, transformer_masks_from_reference(mn),
                           grad_accum, device="cpu")(
        tp, topt.init(tp), batch_np)
    return cr, pn, ref, port


def assert_adamw_step_close(pn, ref, port, lr=1e-3):
    """One AdamW step of the port against the reference's from the numpy
    tree ``pn``: the metrics within ``LOSS_RTOL32``; the first moment
    within ``GRAD_RTOL32`` of its largest entry and the second within
    twice that (it is the square); each parameter within 64 eps of its
    largest entry, except where the reference's gradient lies within the
    gradient tolerance of zero, where AdamW's first step (lr x g / (|g| +
    eps), about lr x sign g) may go either way: there within 2 lr."""
    from repro_torch.interop import transformer_params_to_reference
    (rp, rs, rm), (tp, ts, tm) = ref, port
    assert set(tm) == set(rm)
    for k in rm:
        assert abs(float(tm[k]) - float(rm[k])) <= LOSS_RTOL32 * max(
            abs(float(rm[k])), 1.0)
    assert ts["step"] == int(rs["step"]) == 1
    m_ref, v_ref = _f32_leaves(rs["m"]), _f32_leaves(rs["v"])
    m_got = _f32_leaves(transformer_params_to_reference(ts["m"]))
    v_got = _f32_leaves(transformer_params_to_reference(ts["v"]))
    for got, want, k in ((m_got, m_ref, 1), (v_got, v_ref, 2)):
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= k * GRAD_RTOL32 * np.abs(w).max()
    p0 = _f32_leaves(pn)
    for g, w, start, m in zip(
            _f32_leaves(transformer_params_to_reference(tp)),
            _f32_leaves(rp), p0, m_ref):
        tol = 64 * EPS32 * max(1.0, float(np.abs(start).max()))
        noisy = np.abs(m) <= GRAD_RTOL32 * np.abs(m).max()
        assert (np.abs(g - w) <= tol + np.where(noisy, 2 * lr, 0.0)).all()
