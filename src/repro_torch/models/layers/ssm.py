"""Mamba2 block (state-space duality / SSD, arXiv:2405.21060), the
reference's ``models/layers/ssm.py``.

The full-sequence forward runs the chunked SSD scan through its kernel
wrapper (``kernels.ssd_scan``: the CUDA kernel on the card, its plain
version on the CPU or with ``backend="ref"``), as the reference's Pallas
path does; the products around it (``w_in``, ``w_out``), the causal conv
and the gated norm are plain PyTorch, as they are XLA's in the reference.

Decode: O(1) per token, plain PyTorch as in the reference (which has no
kernel there) — conv rolling state (d_conv-1 taps) + SSM state (H, P, N)
per layer.

Pruning hook: ``head_mask`` (ssm_heads,) zeroes pruned SSD heads, on the
scan's output and on the skip term alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers.norms import gated_rmsnorm


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, conv_dim), the raw pre-conv inputs
    state: torch.Tensor    # (B, H, P, N) float32


def conv_dim(cfg) -> int:
    s = cfg.ssm
    return cfg.d_inner + 2 * s.n_groups * s.d_state


def init_ssm_params(gen: torch.Generator, cfg, dtype: torch.dtype,
                    device: torch.device):
    """The reference's distributions, drawn from ``gen``: ``w_in``/``w_out``
    normal / sqrt(fan_in), ``conv_w`` normal / sqrt(d_conv), zero
    ``conv_b``, ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1], ``D`` ones, unit
    ``norm_scale``. ``A_log``, ``dt_bias`` and ``D`` stay float32 whatever
    ``dtype`` is."""
    s = cfg.ssm
    H = cfg.ssm_heads
    d_in = cfg.d_inner
    cdim = conv_dim(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H
    f32 = torch.float32

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (w * scale).to(dtype)

    w_in = normal((cfg.d_model, proj_out), 1.0 / math.sqrt(cfg.d_model))
    conv_w = normal((s.d_conv, cdim), 1.0 / math.sqrt(s.d_conv))
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
        "w_out": normal((d_in, cfg.d_model), 1.0 / math.sqrt(d_in)),
    }


def _split_proj(cfg, proj: torch.Tensor):
    s = cfg.ssm
    d_in = cfg.d_inner
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv1d. xBC (B,S,Cd), conv_w (K,Cd). The taps are
    multiplied and summed one at a time in xBC's dtype (one rounding per
    tap in a bf16 model, as the reference's ``sum``), then the bias, then
    SiLU in float32."""
    pad = F.pad(xBC, (0, 0, d_conv - 1, 0))
    S = xBC.shape[1]
    out = sum(pad[:, i:i + S] * conv_w[i] for i in range(d_conv))
    return F.silu((out + conv_b).to(torch.float32)).to(xBC.dtype)


def ssm_forward(params, cfg, x: torch.Tensor, *, head_mask=None,
                return_state: bool = False, backend: str = "auto"):
    """Full-sequence Mamba2 block. x (B,S,d_model) -> (B,S,d_model).

    With ``return_state``, also returns an SSMCache holding the rolling conv
    tail (raw pre-conv inputs, left-padded with zeros when S < d_conv - 1)
    and the final SSD state — what ``ssm_decode`` consumes to continue the
    sequence."""
    s = cfg.ssm
    H, P = cfg.ssm_heads, s.head_dim
    Bsz, S = x.shape[:2]
    proj = x @ params["w_in"]
    z, xBC, dt = _split_proj(cfg, proj)
    xBC_raw = xBC
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"], s.d_conv)
    d_in = cfg.d_inner
    gn = s.n_groups * s.d_state
    xs = xBC[..., :d_in].reshape(Bsz, S, H, P)
    Bm = xBC[..., d_in:d_in + gn].reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gn:].reshape(Bsz, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    scan = ssd_scan_ref if backend == "ref" else ssd_scan
    y, state = scan(xs, dt, A, Bm, Cm, head_mask, s.chunk_size)
    skip = params["D"][None, None, :, None] * xs.to(torch.float32)
    if head_mask is not None:
        skip = skip * head_mask[None, None, :, None]
    y = y + skip
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps)
    out = y @ params["w_out"]
    if return_state:
        K = s.d_conv
        if S >= K - 1:
            tail = xBC_raw[:, S - (K - 1):]
        else:
            tail = F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
        return out, SSMCache(tail.to(x.dtype), state)
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
               head_mask=None):
    """One-token decode. x (B,1,d_model) -> (out (B,1,d), new cache). The
    conv window and the state are float32, as in the reference; the new
    cache is returned as new tensors (the stack copies them into its
    stacked cache)."""
    s = cfg.ssm
    H, P = cfg.ssm_heads, s.head_dim
    B = x.shape[0]
    f32 = torch.float32
    proj = x[:, 0] @ params["w_in"]                  # (B, proj_out)
    z, xBC, dt = _split_proj(cfg, proj)
    # rolling conv state
    hist = torch.cat([cache.conv, xBC[:, None]], dim=1)       # (B,K,Cd)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(f32),
                            params["conv_w"].to(f32))
    xBC = F.silu(conv_out + params["conv_b"].to(f32))
    new_conv = hist[:, 1:].to(cache.conv.dtype)

    d_in = cfg.d_inner
    gn = s.n_groups * s.d_state
    xs = xBC[..., :d_in].reshape(B, H, P)
    Bm = xBC[..., d_in:d_in + gn].reshape(B, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gn:].reshape(B, s.n_groups, s.d_state)
    rep = H // s.n_groups
    Bh = Bm.repeat_interleave(rep, dim=1)            # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                        # (B,H)
    state = (cache.state * decay[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt, xs, Bh))
    y = (torch.einsum("bhpn,bhn->bhp", state, Ch)
         + params["D"][None, :, None] * xs)
    if head_mask is not None:
        y = y * head_mask[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = gated_rmsnorm(y, z[:, None], params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"], SSMCache(new_conv, state)
