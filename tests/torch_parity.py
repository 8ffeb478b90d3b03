"""Shared inputs for the ``test_torch_*`` parity tests: one set of numpy
arrays, made from a seed, handed to both the JAX reference (``repro``)
and the PyTorch port (``repro_torch``). Never a ``jax.random`` key: the
reference's PRNG stream moved between JAX versions."""
from __future__ import annotations

import socket

import jax.numpy as jnp
import numpy as np
import torch

from repro.models import cnn as rcnn
from repro_torch.interop import params_from_reference
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import cnn as tcnn

#: fp32 float epsilon (unit roundoff is half of it)
EPS32 = float(np.finfo(np.float32).eps)
#: bf16 keeps 8 significant bits: neighbouring values of magnitude v lie at
#: most 2**-7 * |v| apart, so two roundings of nearby fp32 values to bf16
#: differ by at most their fp32 gap plus that much
BF16_SPACING = 2.0 ** -7


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


def transformer_params_np(cfg, seed: int = 0):
    """A parameter tree of numpy arrays in the reference transformer's
    layout for ``cfg`` (shapes and dtypes from ``jax.eval_shape`` of its
    ``init_params``: ``cfg.dtype``, except the Mamba2 block's float32
    ``A_log``, ``dt_bias`` and ``D``): weights normal / sqrt(fan_in),
    embeddings normal x 0.02, and — unlike the reference's zeros and ones —
    random QKV and conv biases, norm scales near 1 and skip weights ``D``
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
        if name in ("ln1", "ln2", "final_norm", "norm_scale", "D"):
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
