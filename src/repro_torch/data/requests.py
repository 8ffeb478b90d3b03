"""Synthetic request batches for the serving steps (numpy only), in the
layout of the reference's ``launch/specs.batch_specs_for``: ``tokens``
(B, S); an audio config's frame embeddings ``embeds`` (B, S, d_model); a
VLM config's vision embeddings ``vision_embeds`` (B, V, d_model), then
S - V text tokens, and optionally their M-RoPE ids ``mrope_positions``
(3, B, S) with the prefix on a square patch grid. S counts the vision
prefix. The embeddings are standard normal float32 draws: the outputs of
the stubbed frontends (the reference stubs its ViT the same way).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def grid_mrope_positions(B: int, side: int, T: int) -> np.ndarray:
    """M-RoPE ids (3, B, side**2 + T), int32, of a vision prefix on a
    ``side`` x ``side`` patch grid (t = 0, h = i // side, w = i % side)
    followed by T text tokens, whose t = h = w ids continue from the
    grid's largest id + 1, as Qwen2-VL numbers them."""
    i = np.arange(side * side)
    vis = np.stack([np.zeros_like(i), i // side, i % side])
    txt = np.broadcast_to(side + np.arange(T), (3, T))
    pos = np.concatenate([vis, txt], axis=1).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


def request_batch(cfg, B: int, S: int, rng: np.random.Generator,
                  grid: bool = True) -> Dict[str, np.ndarray]:
    """One request batch of ``cfg``'s family drawn from ``rng``: S
    positions in all. A VLM config's batch carries the grid ids when
    ``grid`` is set (the prefix on a square grid of its V embeddings),
    else none, so the stack numbers every position as text."""
    if cfg.embeds_input:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32)}
    V = cfg.vision_tokens or 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - V))}
    if V:
        batch["vision_embeds"] = rng.standard_normal((B, V, cfg.d_model),
                                                     dtype=np.float32)
        if grid:
            batch["mrope_positions"] = grid_mrope_positions(
                B, math.isqrt(V), S - V)
    return batch


def batch_shape(cfg, batch) -> Tuple[int, int]:
    """(B, S) of a request batch: S counts a VLM's vision prefix, or an
    audio config's frames."""
    if cfg.embeds_input:
        return tuple(batch["embeds"].shape[:2])
    B, T = batch["tokens"].shape
    return B, T + (cfg.vision_tokens or 0)
