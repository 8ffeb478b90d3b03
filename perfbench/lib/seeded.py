"""Inputs, weights and masks made from ``--seed``, on the device.

Everything here is drawn from ``torch.Generator``s seeded from the run's
seed and a tag, in a few large calls: a model's weights are one flat
buffer in the type they are served in, filled by ``normal_`` in chunks and
then scaled leaf by leaf in place (views, no copies). The same seed gives
the same tensors; the program and the plain references are handed the
same ones.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

#: elements a single ``normal_`` call fills
_CHUNK = 1 << 30


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _flat_normal(shapes: Dict[str, Tuple[int, ...]], dtype, device,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One buffer of standard normals, cut into views of ``shapes``."""
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.empty(sum(sizes.values()), dtype=dtype, device=device)
    for lo in range(0, flat.numel(), _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for k, s in shapes.items():
        out[k] = flat[off:off + sizes[k]].view(s)
        off += sizes[k]
    return out


# ---------------------------------------------------------------------------
# decoder-only transformer (Qwen2 family)
# ---------------------------------------------------------------------------
def lm_dims(cfg: dict) -> dict:
    """The sizes a dense GQA decoder is built from, read from its
    configuration file (the published ``config.json`` keys)."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "d": d, "H": H,
            "Hkv": cfg["num_key_value_heads"],
            "D": cfg.get("head_dim", d // H), "F": cfg["intermediate_size"],
            "V": cfg["vocab_size"], "eps": cfg["rms_norm_eps"],
            "theta": cfg["rope_theta"], "bias": cfg.get("qkv_bias", True),
            "dtype": getattr(torch, cfg["torch_dtype"])}


def lm_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    L, d, F, V = m["L"], m["d"], m["F"], m["V"]
    q, kv = m["H"] * m["D"], m["Hkv"] * m["D"]
    shapes = {"embed": (V, d), "lm_head": (d, V), "final_norm": (d,),
              "ln1": (L, d), "ln2": (L, d),
              "wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv),
              "wo": (L, q, d), "w_up": (L, d, F), "w_gate": (L, d, F),
              "w_down": (L, F, d)}
    if m["bias"]:
        shapes.update(bq=(L, q), bk=(L, kv), bv=(L, kv))
    return shapes


def lm_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat name -> tensor: embeddings x 0.02, every matrix x 1/sqrt(fan
    in), norm scales 1 + 0.1 n and QKV biases 0.1 n (so the scale and bias
    paths carry numbers), in the served dtype."""
    gen = generator(seed, "lm_weights", device)
    w = _flat_normal(lm_shapes(m), m["dtype"], device, gen)
    with torch.no_grad():
        for k, t in w.items():
            if k == "embed":
                t.mul_(0.02)
            elif k in ("ln1", "ln2", "final_norm"):
                t.mul_(0.1).add_(1.0)
            elif k in ("bq", "bk", "bv"):
                t.mul_(0.1)
            else:
                t.mul_(1.0 / math.sqrt(t.shape[-2]))
    return w


def lm_program_tree(w: Dict[str, torch.Tensor]) -> dict:
    """The flat weights in the tree the port's dense stack reads (one run
    of stacked attention layers)."""
    attn = {k: w[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if k in w}
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "lm_head": w["lm_head"],
            "runs": [{"ln1": w["ln1"], "attn": attn, "ln2": w["ln2"],
                      "mlp": {"w_up": w["w_up"], "w_down": w["w_down"],
                              "w_gate": w["w_gate"]}}]}


def _keep_rows(n_rows: int, n: int, keep: int, gen, device) -> torch.Tensor:
    """(n_rows, n) float32 masks, ``keep`` random ones a row."""
    order = torch.rand((n_rows, n), generator=gen, device=device).argsort(1)
    mask = torch.zeros((n_rows, n), dtype=torch.float32, device=device)
    return mask.scatter_(1, order[:, :keep], 1.0)


def lm_masks(m: dict, ratio: float, seed: int,
             device) -> Dict[str, torch.Tensor]:
    """Each layer keeps ``ratio`` of its KV groups (whole groups, the
    query heads of a kept group with them) and of its FFN channels, drawn
    at random: ``head_mask`` (L, H), ``ffn_mask`` (L, F)."""
    gen = generator(seed, "lm_masks", device)
    L, H, Hkv, F = m["L"], m["H"], m["Hkv"], m["F"]
    groups = _keep_rows(L, Hkv, max(1, round(Hkv * ratio)), gen, device)
    heads = groups.repeat_interleave(H // Hkv, dim=1)
    ffn = _keep_rows(L, F, max(1, round(F * ratio)), gen, device)
    return {"head_mask": heads, "ffn_mask": ffn}


def token_batches(V: int, B: int, lengths: List[int], seed: int,
                  device) -> List[torch.Tensor]:
    """One (B, S) int64 batch of uniform token ids per entry of
    ``lengths``, drawn in order from one generator."""
    gen = generator(seed, "tokens", device)
    return [torch.randint(0, V, (B, S), generator=gen, device=device)
            for S in lengths]


# ---------------------------------------------------------------------------
# CNN (AlexNet family)
# ---------------------------------------------------------------------------
def cnn_layers(cfg: dict) -> List[dict]:
    """The layer list of a CNN configuration file, each entry with its
    input and output shapes (C, H, W) or (F,) filled in."""
    c, (h, w) = cfg["input_channels"], cfg["input_hw"]
    shape: Tuple[int, ...] = (c, h, w)
    out = []
    for spec in cfg["layers"]:
        spec = dict(spec)
        spec["in"] = shape
        kind = spec["kind"]
        if kind == "conv":
            k, s, p = spec["kernel"], spec["stride"], spec["padding"]
            shape = (spec["out_channels"], (shape[1] + 2 * p - k) // s + 1,
                     (shape[2] + 2 * p - k) // s + 1)
        elif kind == "maxpool":
            k, s = spec["kernel"], spec["stride"]
            shape = (shape[0], (shape[1] - k) // s + 1,
                     (shape[2] - k) // s + 1)
        elif kind == "flatten":
            shape = (math.prod(shape),)
        elif kind == "dense":
            shape = (spec["features"],)
        spec["out"] = shape
        out.append(spec)
    return out


def cnn_shapes(layers: List[dict]) -> Dict[str, Tuple[int, ...]]:
    """``l{i}.w`` (HWIO conv, (in, out) dense) and ``l{i}.b`` shapes."""
    shapes = {}
    for i, spec in enumerate(layers):
        if spec["kind"] == "conv":
            k = spec["kernel"]
            shapes[f"l{i}.w"] = (k, k, spec["in"][0], spec["out_channels"])
            shapes[f"l{i}.b"] = (spec["out_channels"],)
        elif spec["kind"] == "dense":
            shapes[f"l{i}.w"] = (spec["in"][0], spec["features"])
            shapes[f"l{i}.b"] = (spec["features"],)
    return shapes


def cnn_weights(layers: List[dict], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """He-normal fp32 weights and biases 0.05 n, as flat ``l{i}.w`` /
    ``l{i}.b`` views of one buffer."""
    gen = generator(seed, "cnn_weights", device)
    w = _flat_normal(cnn_shapes(layers), torch.float32, device, gen)
    with torch.no_grad():
        for k, t in w.items():
            if k.endswith(".b"):
                t.mul_(0.05)
            else:
                t.mul_(math.sqrt(2.0 / math.prod(t.shape[:-1])))
    return w


def cnn_program_params(w: Dict[str, torch.Tensor]) -> dict:
    """The flat weights as the port's ``{"l{i}": {"w", "b"}}`` tree."""
    out: dict = {}
    for k, t in w.items():
        layer, leaf = k.split(".")
        out.setdefault(layer, {})[leaf] = t
    return out


def prunable(layers: List[dict]) -> List[int]:
    """Every conv and every dense layer but the classifier head."""
    convs = [i for i, s in enumerate(layers) if s["kind"] == "conv"]
    dense = [i for i, s in enumerate(layers) if s["kind"] == "dense"]
    return convs + dense[:-1]


def cnn_masks(layers: List[dict], ratio: float, seed: int,
              device) -> Dict[int, torch.Tensor]:
    """``ratio`` of each prunable layer's channels kept, at random."""
    gen = generator(seed, "cnn_masks", device)
    out = {}
    for i in prunable(layers):
        n = layers[i]["out"][0]
        out[i] = _keep_rows(1, n, max(1, round(n * ratio)), gen, device)[0]
    return out


def leaf_images(n: int, hw: int, classes: int, seed: int, device,
                batch: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` (hw, hw, 3) float32 images in [0, 1] and their labels: the
    recipe of the port's ``PlantVillageSynthetic`` (a leaf-green base with
    a class tint, three oriented gratings, two to four class-coloured
    blobs, noise and a brightness jitter), vectorized on the device.
    Classes cycle 0, 1, ..., so every class is present."""
    gen = generator(seed, "leaf_images", device)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(  # noqa: E731
        s, generator=gen, device=device)
    # each class's signature
    freqs = u(2, 12, classes, 3)
    orients = u(0, math.pi, classes, 3)
    weights = u(0.3, 1.0, classes, 3)
    blob_color = u(0, 1, classes, 2, 3)
    tint = u(-1, 1, classes, 3)
    base = torch.tensor([0.18, 0.42, 0.12], device=device) \
        + u(-0.05, 0.05, classes, 3)
    labels = torch.arange(n, device=device) % classes
    yy, xx = torch.meshgrid(torch.arange(hw, device=device) / hw,
                            torch.arange(hw, device=device) / hw,
                            indexing="ij")
    images = torch.empty((n, hw, hw, 3), dtype=torch.float32, device=device)
    for lo in range(0, n, batch):
        c = labels[lo:lo + batch]
        m = c.shape[0]
        img = (base[c] + 0.12 * tint[c])[:, None, None, :].expand(
            m, hw, hw, 3).clone()
        ph = u(0, 2 * math.pi, m, 3)
        for g in range(3):
            o = orients[c, g][:, None, None]
            arg = (2 * math.pi * freqs[c, g][:, None, None]
                   * (xx * torch.cos(o) + yy * torch.sin(o))
                   + ph[:, g, None, None])
            img += (0.12 * weights[c, g][:, None, None]
                    * torch.sin(arg))[..., None]
        n_blobs = 2 + c % 3
        centres, radii = u(0.15, 0.85, m, 4, 2), u(0.05, 0.15, m, 4)
        for b in range(4):
            cy = centres[:, b, 0, None, None]
            cx = centres[:, b, 1, None, None]
            r = radii[:, b, None, None]
            blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            blob = blob * (b < n_blobs).to(blob.dtype)[:, None, None]
            img += 0.5 * blob[..., None] * (
                blob_color[c, b % 2][:, None, None, :] - img)
        img += 0.02 * torch.randn(img.shape, generator=gen, device=device)
        img *= u(0.85, 1.15, m)[:, None, None, None]
        images[lo:lo + m] = img.clamp_(0, 1)
    return images, labels
