"""The bf16 ``ssd_scan`` kernel's numerics, emulated on the CPU.

On the card the bf16 entry runs Mamba2's chunked decomposition in three
passes over chunks of 256 steps (``csrc/ssd_scan.cu``): the chunk-local
states, the state pass across chunks, the outputs. Its products run on the
bf16 tensor cores with float32 accumulators: C, B and x enter exactly (they
are bf16), and each float32 left operand (the decayed x of pass 1, the
weighted W tile and the carried state of pass 3) enters as bf16 parts,
``hi = bf16(v)``, ``lo = bf16(v - hi)``, and for pass 1 of a prompt shorter
than a chunk a third, the bf16 of what is left. The emulation below does the same arithmetic in plain
PyTorch (float32 sums in another order than the kernel's) and is held
against the reference's Pallas kernel in interpret mode and against the
port's plain version, within ``ssd_tolerance``, the tolerance
``chip_smoke.py`` holds the kernel to on the card. Two parts keep about 16
of float32's 24 bits (a product errs by at most 2⁻¹⁶ of itself), inside
the (N + Q + n_chunks + 2·max|cs|)·eps32 of that bound for y, whose bf16
rounding dominates anyway. The final state is float32 and comes from pass
1 alone: its bound is (N + 256 + ...)·eps32 once the prompt fills a chunk,
but as tight as (N + 2)·eps32 at S = 1, less than 2⁻¹⁶, so for a prompt
shorter than a chunk pass 1 takes three parts, float32's own precision."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_scan
from repro_torch.interop import transformer_params_from_reference as to_port
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from torch_parity import BF16_SPACING, ssd_inputs, ssd_tolerance, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

#: the kernel's chunk, and the steps of its pass-3 tiles
Q = ops.CHUNK
RT = 64


def _bf16_parts(v: torch.Tensor, parts: int):
    """A float32 tensor as the bf16 operands the kernel multiplies: hi =
    bf16(v), then each next part the bf16 of what is left (exact in
    float32)."""
    out = []
    for _ in range(parts):
        out.append(v.to(torch.bfloat16).float())
        v = v - out[-1]
    return out


def _split_product(eq: str, left: torch.Tensor, right: torch.Tensor,
                   parts: int = 2):
    """``einsum(eq, left, right)`` with the float32 ``left`` split into
    ``parts`` bf16 operands, one product each, summed in float32."""
    terms = [torch.einsum(eq, t, right) for t in _bf16_parts(left, parts)]
    return sum(terms[1:], terms[0])


def three_passes(xh, dt, A, Bm, Cm, head_mask):
    """The bf16 entry's arithmetic: (y (B,S,H,P) bf16 times the head mask,
    final state (B,H,P,N) float32)."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    pad = nc * Q - S            # steps past S enter as zeros, dt = 0 there
    f = torch.nn.functional.pad
    x = f(xh.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    d = f(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    rep = H // G
    Bh = f(Bm.float(), (0, 0, 0, 0, 0, pad)).reshape(
        Bsz, nc, Q, G, N).repeat_interleave(rep, 3)
    Ch = f(Cm.float(), (0, 0, 0, 0, 0, pad)).reshape(
        Bsz, nc, Q, G, N).repeat_interleave(rep, 3)
    cs = torch.cumsum(d * A, dim=2)                            # (B,nc,Q,H)

    # pass 1: each chunk's own state from its decayed x
    w = d * torch.exp(cs[:, :, -1:] - cs)
    own = _split_product("bcqhp,bcqhn->bchpn", x * w[..., None], Bh,
                         2 if S >= Q else 3)
    # pass 2: the states carried into the chunks, in chunk order
    h = torch.zeros((Bsz, H, P, N))
    carried = []
    for c in range(nc):
        carried.append(h)
        h = h * torch.exp(cs[:, c, -1])[..., None, None] + own[:, c]
    carried = torch.stack(carried, 1)                          # (B,nc,H,P,N)
    # pass 3: y from W = (C B^T) o L o dt, L selected only where j <= i;
    # below the query row's 64-step tile L = exp(cs_i - e) exp(e - cs_j), e
    # the last cs of j's tile, the step's factor carrying dt
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    csh = cs.permute(0, 1, 3, 2)                               # (B,nc,H,Q)
    dth = d.permute(0, 1, 3, 2)
    tile = torch.arange(Q) // RT
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    below = tile[:, None] > tile[None, :]
    e = csh.reshape(*csh.shape[:-1], Q // RT, RT)[..., -1][..., tile]
    u = dth * torch.exp(e - csh)                               # per step j
    v = torch.exp(csh[..., :, None] - e[..., None, :])         # per (i, j)
    decay = torch.exp(torch.where(causal, csh[..., :, None] - csh[..., None, :],
                                  float("-inf")))
    W = torch.where(below, cb * (v * u[..., None, :]),
                    torch.where(causal, cb * decay * dth[..., None, :], 0.0))
    y = _split_product("bchij,bcjhp->bcihp", W, x)
    y = y + torch.exp(cs)[..., None] * _split_product(
        "bchpn,bcihn->bcihp", carried, Ch)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S] * head_mask[None, None, :, None]
    return y.to(torch.bfloat16), h


# name: (B, S, H, G, P, N); Mamba2-like heads at small widths, ragged tails
CASES = {
    "one_ragged_chunk": (1, 77, 4, 1, 16, 32),
    "two_chunks_groups_2": (2, 300, 4, 2, 16, 32),
    "three_chunks": (1, 520, 4, 1, 32, 16),
    "whole_chunk": (1, 256, 4, 2, 16, 16),
    "s1": (2, 1, 4, 1, 16, 32),
}


def _hm(H):
    m = np.zeros(H, np.float32)
    m[np.random.default_rng(1).permutation(H)[:H // 2]] = 1.0
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_passes_match_reference_pallas_kernel(case):
    """y (pruned heads exact zeros) and the final state of every head
    within the stated tolerance of the reference's kernel at chunk 256."""
    B, S, H, G, P, N = CASES[case]
    args = ssd_inputs(B, S, H, G, P, N, "bfloat16", seed=11)
    hm = _hm(H)
    want_y, want_s = ref_ssd_scan(*(jnp.asarray(a) for a in args),
                                  head_mask=jnp.asarray(hm), chunk=Q,
                                  interpret=True)
    got_y, got_s = three_passes(*(to_port(a) for a in args),
                                torch.from_numpy(hm))
    tol_y, tol_s = ssd_tolerance(*args, Q)
    tol_y = tol_y * hm[None, None, :, None]
    tol_y = tol_y + BF16_SPACING * (np.abs(to_f32(want_y)) + tol_y)
    assert (np.abs(to_f32(got_y) - to_f32(want_y)) <= tol_y).all()
    assert (np.abs(to_f32(got_s) - to_f32(want_s)) <= tol_s).all()
    assert (to_f32(got_y)[:, :, hm == 0] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_passes_match_plain_version(case):
    """The same against the port's plain version (the yardstick the kernel
    is held to on the card)."""
    B, S, H, G, P, N = CASES[case]
    args = ssd_inputs(B, S, H, G, P, N, "bfloat16", seed=12)
    hm = torch.from_numpy(_hm(H))
    t = [to_port(a) for a in args]
    want_y, want_s = ssd_scan_ref(*t, hm, Q)
    got_y, got_s = three_passes(*t, hm)
    tol_y, tol_s = ssd_tolerance(*args, Q)
    tol_y = tol_y * hm.numpy()[None, None, :, None]
    tol_y = tol_y + BF16_SPACING * (np.abs(to_f32(want_y)) + tol_y)
    assert (np.abs(to_f32(got_y) - to_f32(want_y)) <= tol_y).all()
    assert (np.abs(to_f32(got_s) - to_f32(want_s)) <= tol_s).all()


@pytest.mark.parametrize("parts, bits", [(2, 16), (3, 24)])
def test_split_keeps_its_bits(parts, bits):
    """Two bf16 parts are within 2⁻¹⁶ of v, relative, three within 2⁻²⁴
    (float32's own rounding), over float32 values of every sign and
    magnitude the passes meet."""
    rng = np.random.default_rng(13)
    v = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-30, 30, 100_000)))
                         .astype(np.float32))
    got = sum(_bf16_parts(v, parts)).double()
    assert ((got - v.double()).abs() <= 2.0 ** -bits * v.double().abs()).all()


@pytest.mark.parametrize("width, ok", [(4 * 64 + 2 * 32, True),
                                       (4 * 64 + 2 * 32 + 4, False)])
def test_bf16_slices_go_in_when_rows_copy_in_16_bytes(width, ok):
    """The bf16 entry copies rows of x, B and C 16 bytes at a time: the
    conv output's slices go in as they lie when their step stride is a
    multiple of 8 bf16 (the Mamba2 block's H·P + 2·G·N always is), else
    the wrapper copies them; float32 slices go in either way."""
    xBC = torch.zeros((2, 10, width), dtype=torch.bfloat16)
    x = xBC[..., :4 * 64].reshape(2, 10, 4, 64)
    Bm = xBC[..., 4 * 64:4 * 64 + 32].reshape(2, 10, 1, 32)
    assert ops._strides_ok(x) == ok and ops._strides_ok(Bm) == ok
    assert ops._strides_ok(xBC.float()[..., :4 * 64].reshape(2, 10, 4, 64))


def test_misaligned_contiguous_bf16_operands_are_copied_to_new_memory():
    """A contiguous bf16 view at an address off the 16-byte rule (a flat
    buffer's slice at an odd offset) stays misaligned under
    ``contiguous()``: the wrapper copies it into new memory, and hands
    operands that already pass through untouched."""
    flat = torch.zeros(1 + 2 * 10 * 4 * 64 + 2 * 2 * 10 * 32,
                       dtype=torch.bfloat16)
    x = flat[1:1 + 2 * 10 * 4 * 64].view(2, 10, 4, 64)
    Bm = flat[1 + 2 * 10 * 4 * 64:1 + 2 * 10 * (4 * 64 + 32)].view(
        2, 10, 1, 32)
    Cm = flat[1 + 2 * 10 * (4 * 64 + 32):].view(2, 10, 1, 32)
    assert x.is_contiguous() and not ops._strides_ok(x.contiguous())
    lx, lB, lC = ops._kernel_layout(x, Bm, Cm)
    assert all(ops._strides_ok(t) for t in (lx, lB, lC))
    assert torch.equal(lx, x) and torch.equal(lB, Bm) and torch.equal(lC, Cm)
    ax, aB, aC = (torch.zeros_like(t) for t in (x, Bm, Cm))
    assert all(u is v for u, v in zip(ops._kernel_layout(ax, aB, aC),
                                      (ax, aB, aC)))
