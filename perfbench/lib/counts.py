"""Operations and bytes the work of a cell needs, from shapes alone.

The counts are of the mathematics, not of what a kernel happens to do:
kept units only under the masks (a pruned head, FFN channel or conv
channel needs nothing), each input read once and each output written
once. A kernel's least time is its count over the peaks of ``peaks``
(the larger of the operation and the byte bound); a share of a roofline
is that least time over the kernel's device time.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from perfbench.lib.peaks import FLOP_S, least_s


# ---------------------------------------------------------------------------
# dense GQA decoder (``seeded.lm_dims``), ``k`` the kept units of a layer
# ---------------------------------------------------------------------------
def lm_kept(m: dict, ratio: float) -> dict:
    """Kept query heads, KV heads and FFN channels of every layer."""
    gk = max(1, round(m["Hkv"] * ratio))
    return {"hk": gk * (m["H"] // m["Hkv"]), "gk": gk,
            "fk": max(1, round(m["F"] * ratio))}


def lm_token_flops(m: dict, k: dict) -> float:
    """Projections and FFN of one token through every layer (no
    attention, no head)."""
    d, D = m["d"], m["D"]
    per_layer = 2 * d * D * (k["hk"] + 2 * k["gk"]) + 2 * k["hk"] * D * d \
        + 3 * 2 * d * k["fk"]
    return m["L"] * per_layer


def lm_attn_flops(m: dict, k: dict, keys: float) -> float:
    """Scores and the weighted sum of values, kept heads, for query-key
    pairs summing to ``keys``, through every layer."""
    return m["L"] * 4 * k["hk"] * m["D"] * keys


def lm_prefill_flops(m: dict, k: dict, B: int, S: int) -> float:
    """A causal prefill of B rows of S tokens, the head on the last
    position."""
    return (B * S * lm_token_flops(m, k)
            + lm_attn_flops(m, k, B * S * (S + 1) / 2)
            + 2 * B * m["d"] * m["V"])


def lm_decode_flops(m: dict, k: dict, B: int, keys: float) -> float:
    """A decode step of B rows whose tokens see ``keys`` positions in
    all (the cache's and their own)."""
    return (B * lm_token_flops(m, k) + lm_attn_flops(m, k, keys)
            + 2 * B * m["d"] * m["V"])


def masked_matmul_bf16(M: int, K: int, N: int, kept: int) -> float:
    """Least seconds of a bf16 (M, K) x (K, N) product of which ``kept``
    columns survive: A read once, the kept columns of B read and of C
    written, the fp32 column mask read."""
    flops = 2.0 * M * K * kept
    nbytes = 2.0 * (M * K + K * kept + M * kept) + 4.0 * N
    return least_s(flops, nbytes, "bfloat16")


def flash_bf16(B: int, S: int, hk: int, gk: int, D: int) -> float:
    """Least seconds of a causal bf16 attention over S positions, kept
    heads only: Q of ``hk`` heads and K, V of ``gk`` groups read, the
    output of ``hk`` heads written."""
    flops = 4.0 * B * hk * D * S * (S + 1) / 2
    nbytes = 2.0 * B * S * D * (2 * hk + 2 * gk)
    return least_s(flops, nbytes, "bfloat16")


def lm_prefill_kernels(m: dict, k: dict, B: int, S: int) -> Dict[str, float]:
    """The least seconds, summed over one prefill's calls, of the
    kernels it runs by hand: the masked up and gate products of every
    layer and one attention a layer."""
    M = B * S
    return {"masked_matmul": 2 * m["L"] * masked_matmul_bf16(
                M, m["d"], m["F"], k["fk"]),
            "flash_attention": m["L"] * flash_bf16(B, S, k["hk"], k["gk"],
                                                   m["D"])}


def lm_decode_kernels(m: dict, k: dict, B: int) -> Dict[str, float]:
    """The same for one decode step of B rows (no attention kernel)."""
    return {"masked_matmul": 2 * m["L"] * masked_matmul_bf16(
        B, m["d"], m["F"], k["fk"])}


# ---------------------------------------------------------------------------
# CNN (``seeded.cnn_layers``), compacted to the kept channels
# ---------------------------------------------------------------------------
def cnn_kept_layers(layers: List[dict], kept: Dict[int, int]) -> List[dict]:
    """Per conv / dense layer: its GEMM (M per image, K, N) after the
    masks' channels are taken out (``kept[i]``: layer i's kept count)."""
    out, c_in = [], layers[0]["in"][0]
    flat_from = None
    for i, spec in enumerate(layers):
        if spec["kind"] == "conv":
            n = kept.get(i, spec["out_channels"])
            kk = spec["kernel"] ** 2
            out.append({"layer": i, "kind": "conv",
                        "M": spec["out"][1] * spec["out"][2],
                        "K": kk * c_in, "N": n})
            c_in = n
        elif spec["kind"] == "flatten":
            flat_from = spec["in"][1] * spec["in"][2] * c_in
        elif spec["kind"] == "dense":
            k_in = flat_from if flat_from is not None else c_in
            n = kept.get(i, spec["features"])
            out.append({"layer": i, "kind": "dense", "M": 1, "K": k_in,
                        "N": n})
            c_in, flat_from = n, None
    return out


def gemm_flops(g: dict) -> float:
    return 2.0 * g["M"] * g["K"] * g["N"]


def cnn_forward_flops(gemms: Iterable[dict]) -> float:
    """One image through the given GEMMs (pools and ReLUs are not
    counted: they are no operations of a roofline's kind)."""
    return sum(gemm_flops(g) for g in gemms)


def q8_splitk(g: dict) -> float:
    """Least seconds of one image's conv as the int8-code GEMM: fp32
    patches in and out, one byte a weight code, fp32 scale, zero and
    column mask, the products at the int8 rate."""
    M, K, N = g["M"], g["K"], g["N"]
    nbytes = 4.0 * M * K + K * N + 12.0 * N + 4.0 * M * N
    return least_s(gemm_flops(g), nbytes, "int8")


def mixed_least_s(flops_by_dtype: Dict[str, float]) -> float:
    """The least time of work in several dtypes: each part at its own
    peak, the parts one after another."""
    return sum(f / FLOP_S[dt] for dt, f in flops_by_dtype.items())
