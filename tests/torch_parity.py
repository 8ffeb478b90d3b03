"""Shared inputs for the ``test_torch_*`` parity tests: one set of numpy
arrays, made from a seed, handed to both the JAX reference (``repro``)
and the PyTorch port (``repro_torch``). Never a ``jax.random`` key: the
reference's PRNG stream moved between JAX versions."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro.models import cnn as rcnn
from repro_torch.interop import params_from_reference
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
    layout for ``cfg`` (shapes from ``jax.eval_shape`` of its
    ``init_params``), in ``cfg.dtype``: weights normal / sqrt(fan_in),
    embeddings normal x 0.02, and — unlike the reference's zeros and ones —
    random QKV biases and norm scales near 1, so the bias and scale paths
    carry real numbers."""
    import jax
    from repro.models import transformer as rtr
    shapes = jax.eval_shape(lambda: rtr.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(cfg.dtype)

    def leaf(path, sd):
        name = path[-1].key
        shp = sd.shape
        if name in ("ln1", "ln2", "final_norm"):
            a = 1.0 + 0.1 * rng.standard_normal(shp)
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * rng.standard_normal(shp)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(shp)
        else:   # (count, fan_in, fan_out) stacked, or (fan_in, fan_out)
            a = rng.standard_normal(shp) / np.sqrt(shp[-2])
        return np.asarray(a.astype(np.float32)).astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
