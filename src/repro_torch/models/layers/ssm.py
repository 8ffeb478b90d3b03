"""Mamba2 block (state-space duality / SSD, arXiv:2405.21060), the
reference's ``models/layers/ssm.py``.

The full-sequence forward runs the chunked SSD scan through its kernel
wrapper (``kernels.ssd_scan``: the CUDA kernel on the card, its plain
version on the CPU or with ``backend="ref"``), as the reference's Pallas
path does, and the gated norm through the rmsnorm kernel's gated entry
(``kernels.rmsnorm.ops.gated_rmsnorm``, which reads z in place from the
input projection); the products around them (``w_in``, ``w_out``) and
the causal conv are plain PyTorch, as they are XLA's in the reference.

Decode: O(1) per token — conv rolling state (d_conv-1 taps) + SSM state
(H, P, N) per layer, plain PyTorch as in the reference (which has no
kernel there), then the same gated norm entry.

Pruning hook: ``head_mask`` (ssm_heads,) zeroes pruned SSD heads, on the
scan's output and on the skip term alike.

Tensor parallelism: with ``tp`` (a ``sharding.tensor_parallel.
TensorParallel``) the block is one rank's share of its SSD heads.
``params`` hold the rank's leaves (``w_in``'s columns of its heads' z, x
and dt and of its groups' B and C, the conv's channels of its x, B and C,
its heads' ``A_log``, ``dt_bias``, ``D`` and ``norm_scale`` columns,
``w_out``'s rows), the scan runs on its heads (each head's group's B and C
repeated where the block crosses groups unevenly), the gated norm's mean
of squares is the whole ``d_inner``'s (``split_gated_rmsnorm``: the row
sums all-reduced), and the out product's partial sums are all-reduced.
The cache holds the rank's shard of ``cache_specs``' layout: its writes
and reads go through ``tp`` (``store_conv``, ``read_conv``,
``write_conv``, ``store_state``, ``read_state``).

Context parallelism: where ``tp.seq`` splits the positions over the data
axes (``sharding.context_parallel``), x is this rank's block of them. The
causal conv takes the ``d_conv - 1`` raw rows before the block from the
ranks below (``SeqSplit.halo``); the scan runs on the block from a zero
state, and the incoming state's part is added from the ranks' final states
and decays folded in rank order (``SeqSplit.ssd_carry``); every rank keeps
the whole sequence's final state and conv tail.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers.init import normal, slot
from repro_torch.models.layers.norms import (gated_rmsnorm,
                                             split_gated_rmsnorm)


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, conv_dim), the raw pre-conv inputs
    state: torch.Tensor    # (B, H, P, N) float32


def conv_dim(cfg) -> int:
    s = cfg.ssm
    return cfg.d_inner + 2 * s.n_groups * s.d_state


def init_ssm_params(gen: torch.Generator, cfg, dtype: torch.dtype,
                    device: torch.device, out=None):
    """The reference's distributions, drawn from ``gen``: ``w_in``/``w_out``
    normal / sqrt(fan_in), ``conv_w`` normal / sqrt(d_conv), zero
    ``conv_b``, ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1], ``D`` ones, unit
    ``norm_scale``. ``A_log``, ``dt_bias`` and ``D`` stay float32 whatever
    ``dtype`` is. The weights go into their slots of ``out`` where given
    (``layers.init``)."""
    s = cfg.ssm
    H = cfg.ssm_heads
    d_in = cfg.d_inner
    cdim = conv_dim(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H
    f32 = torch.float32

    def draw(name, shape, scale):
        return normal(gen, shape, dtype, device, mul=scale,
                      out=slot(out, name))

    w_in = draw("w_in", (cfg.d_model, proj_out), 1.0 / math.sqrt(cfg.d_model))
    conv_w = draw("conv_w", (s.d_conv, cdim), 1.0 / math.sqrt(s.d_conv))
    u = torch.rand((H,), generator=gen, dtype=f32, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((cdim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "w_out": draw("w_out", (d_in, cfg.d_model), 1.0 / math.sqrt(d_in)),
    }


def _widths(cfg, tp):
    """(heads, groups): the block's, or with ``tp`` the rank's (its head
    block and the groups its heads read)."""
    if tp is None:
        return cfg.ssm_heads, cfg.ssm.n_groups
    (h0, h1), (g0, g1) = tp.ssd.q, tp.ssd.kv
    return h1 - h0, g1 - g0


def _split_proj(proj: torch.Tensor, d_in: int, gn: int):
    """(z, xBC, dt) of the packed input projection: z and x ``d_in`` wide,
    B and C ``gn`` each, then dt."""
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn:]
    return z, xBC, dt


def _norm(y, z, scale, cfg, backend: str, tp):
    """The gated norm: one entry, or with ``tp`` over more than one rank
    the split form over its axis."""
    if tp is None or tp.axis.size == 1:
        return gated_rmsnorm(y, z, scale, cfg.norm_eps, backend=backend)
    return split_gated_rmsnorm(y, z, scale, cfg.norm_eps, tp.axis,
                               cfg.d_inner, backend=backend)


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, d_conv: int,
                 halo=None) -> torch.Tensor:
    """Depthwise causal conv1d. xBC (B,S,Cd), conv_w (K,Cd). The taps are
    multiplied and summed one at a time in xBC's dtype (one rounding per
    tap in a bf16 model, as the reference's ``sum``), then the bias, then
    SiLU in float32. ``halo`` (B, K-1, Cd), where given, is the rows
    before xBC (a sequence block's), else zeros."""
    if halo is None:
        pad = F.pad(xBC, (0, 0, d_conv - 1, 0))
    else:
        pad = torch.cat([halo.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(pad[:, i:i + S] * conv_w[i] for i in range(d_conv))
    return F.silu((out + conv_b).to(torch.float32)).to(xBC.dtype)


def ssm_forward(params, cfg, x: torch.Tensor, *, head_mask=None,
                return_state: bool = False, backend: str = "auto", tp=None):
    """Full-sequence Mamba2 block. x (B,S,d_model) -> (B,S,d_model).

    With ``return_state``, also returns an SSMCache holding the rolling conv
    tail (raw pre-conv inputs, left-padded with zeros when S < d_conv - 1)
    and the final SSD state — what ``ssm_decode`` consumes to continue the
    sequence (with ``tp``, the rank's shard of each; with ``tp.seq``, the
    whole sequence's)."""
    s = cfg.ssm
    P, N = s.head_dim, s.d_state
    H, G = _widths(cfg, tp)
    d_in, gn = H * P, G * N
    Bsz, S = x.shape[:2]
    seq = None if tp is None else tp.seq_tokens
    if tp is not None:
        x = tp.copy_in(x)
    proj = x @ params["w_in"]
    z, xBC, dt = _split_proj(proj, d_in, gn)
    xBC_raw = xBC
    halo = tail = None
    if seq is not None:
        halo, tail = seq.halo(xBC_raw, s.d_conv - 1)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"], s.d_conv,
                       halo)
    xs = xBC[..., :d_in].reshape(Bsz, S, H, P)
    Bm = xBC[..., d_in:d_in + gn].reshape(Bsz, S, G, N)
    Cm = xBC[..., d_in + gn:].reshape(Bsz, S, G, N)
    if tp is not None:
        Bm, Cm = tp.ssd_groups(Bm, 2), tp.ssd_groups(Cm, 2)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    scan = ssd_scan_ref if backend == "ref" else ssd_scan
    y, state = scan(xs, dt, A, Bm, Cm, head_mask, s.chunk_size)
    if seq is not None:
        Ch = Cm.repeat_interleave(H // Cm.shape[2], dim=2)
        y, state = seq.ssd_carry(y, state, dt, A, Ch, head_mask)
    skip = params["D"][None, None, :, None] * xs.to(torch.float32)
    if head_mask is not None:
        skip = skip * head_mask[None, None, :, None]
    y = y + skip
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = _norm(y, z, params["norm_scale"], cfg, backend, tp)
    out = y @ params["w_out"]
    if tp is not None:
        out = tp.reduce(out)
    if return_state:
        K = s.d_conv
        if tail is None:            # else the sequence's, from the halo
            tail = (xBC_raw[:, S - (K - 1):] if S >= K - 1
                    else F.pad(xBC_raw, (0, 0, K - 1 - S, 0)))
        tail = tail.to(x.dtype)
        if tp is not None:
            tail, state = tp.store_conv(tail), tp.store_state(state)
        return out, SSMCache(tail, state)
    return out


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype,
                   device: torch.device) -> SSMCache:
    s = cfg.ssm
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device))


def ssm_decode(params, cfg, x: torch.Tensor, cache: SSMCache, *,
               head_mask=None, backend: str = "auto", tp=None):
    """One-token decode. x (B,1,d_model) -> (out (B,1,d), new cache). The
    conv window and the state are float32, as in the reference; the new
    cache is returned as new tensors (the stack copies them into its
    stacked cache). ``backend="ref"`` runs the gated norm's plain
    version. With ``tp`` the cache is the rank's shard: its conv channels
    are read from the shards and its new row sent to them, its heads' state
    read from and written to its state shard."""
    s = cfg.ssm
    P, N = s.head_dim, s.d_state
    H, G = _widths(cfg, tp)
    d_in, gn = H * P, G * N
    B = x.shape[0]
    f32 = torch.float32
    if tp is not None:
        x = tp.copy_in(x)
    proj = x[:, 0] @ params["w_in"]                  # (B, proj_out)
    z, xBC, dt = _split_proj(proj, d_in, gn)
    # rolling conv state
    tail = cache.conv if tp is None else tp.read_conv(cache.conv)
    hist = torch.cat([tail, xBC[:, None]], dim=1)             # (B,K,Cd)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(f32),
                            params["conv_w"].to(f32))
    xBC = F.silu(conv_out + params["conv_b"].to(f32))
    if tp is None:
        new_conv = hist[:, 1:].to(cache.conv.dtype)
    else:
        new_conv = tp.write_conv(cache.conv,
                                 hist[:, -1:].to(cache.conv.dtype))

    xs = xBC[..., :d_in].reshape(B, H, P)
    Bm = xBC[..., d_in:d_in + gn].reshape(B, G, N)
    Cm = xBC[..., d_in + gn:].reshape(B, G, N)
    if tp is not None:
        Bm, Cm = tp.ssd_groups(Bm, 1), tp.ssd_groups(Cm, 1)
    rep = H // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1)            # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                        # (B,H)
    prev = cache.state if tp is None else tp.read_state(cache.state)
    state = (prev * decay[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt, xs, Bh))
    y = (torch.einsum("bhpn,bhn->bhp", state, Ch)
         + params["D"][None, :, None] * xs)
    if head_mask is not None:
        y = y * head_mask[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = _norm(y, z[:, None], params["norm_scale"], cfg, backend, tp)
    out = y @ params["w_out"]
    if tp is None:
        return out, SSMCache(new_conv, state)
    return tp.reduce(out), SSMCache(new_conv, tp.store_state(state))
