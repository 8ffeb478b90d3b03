"""Config dataclasses, copied from the JAX package's ``configs/base.py``.

Field names, order and defaults are identical to the reference's. The CNN
plan digest hashes ``dataclasses.asdict`` of ``CNNConfig``, so two peers
agree on a plan only if the fields do. The transformer dataclasses
(``ModelConfig`` and its parts) and ``reduce_for_smoke`` are copied field
for field, so a config file of either package describes the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden dim
    num_shared: int = 0           # always-on shared experts (DeepSeek-V3)
    capacity_factor: float = 1.0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # DeepSeek-V3 style sigmoid routing with bias-based balancing
    score_fn: str = "softmax"     # "softmax" | "sigmoid"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block shape."""
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu_glu"  # silu_glu | geglu | gelu | sq_relu
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    attention: str = "gqa"        # gqa | mla | none
    causal: bool = True           # False => bidirectional encoder (hubert)
    sliding_window: Optional[int] = None
    rope_mode: str = "standard"   # standard | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()
    moe: Optional[MoEConfig] = None
    # layers that use dense FFN even in an MoE model (DeepSeek-V3: first 3)
    num_dense_layers: int = 0
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a single SHARED attention block applied after every
    # `shared_attn_period` ssm layers.
    shared_attn_period: int = 0
    tie_embeddings: bool = False
    scale_embeddings: bool = False          # gemma: embeds * sqrt(d_model)
    logit_softcap: Optional[float] = None   # gemma-style final-logit softcap
    # vlm: stubbed vision frontend feeds patch embeddings of this many tokens
    vision_tokens: int = 0
    # audio: stubbed conv frontend feeds frame embeddings directly
    embeds_input: bool = False
    # MTP: auxiliary next-next-token prediction head depth (DeepSeek-V3)
    mtp_depth: int = 0
    vocab_pad_to: int = 0          # pad vocab for even sharding (0 = none)
    dtype: str = "bfloat16"
    remat: bool = True
    # scan_layers=False unrolls the layer stack into straight-line HLO.
    # Used by the dry-run: XLA's HloCostAnalysis counts a while-loop body
    # ONCE regardless of trip count, so roofline FLOPs/bytes/collectives
    # must come from unrolled lowerings (see roofline/analysis.py).
    scan_layers: bool = True
    # unroll the chunked-attention KV-block scan (same cost_analysis reason)
    attn_block_unroll: bool = False
    # naive (S^2-materializing) attention below this length; chunked above
    naive_attn_max: int = 4096
    # head-atomic chunked attention: keep H as one dim (sharding-friendly
    # when the model axis divides neither Hkv nor the GQA group; §Perf-1)
    attn_head_atomic: bool = False
    citation: str = ""

    # ---- derived helpers -------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to and self.vocab_size % self.vocab_pad_to:
            return (self.vocab_size // self.vocab_pad_to + 1) * self.vocab_pad_to
        return self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner dim."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn', 'moe', 'ssm'."""
        if self.arch_type in ("dense", "audio", "vlm"):
            return ("attn",) * self.num_layers
        if self.arch_type == "moe":
            kinds = []
            for i in range(self.num_layers):
                kinds.append("attn_dense" if i < self.num_dense_layers else "moe")
            return tuple(kinds)
        if self.arch_type in ("ssm", "hybrid"):
            return ("ssm",) * self.num_layers
        raise ValueError(self.arch_type)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    head_dim = 64
    num_heads = max(2, d_model // head_dim)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    # preserve the GQA-vs-MHA character
    if cfg.num_kv_heads < cfg.num_heads:
        num_kv = max(1, num_heads // 2)
    else:
        num_kv = num_heads
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        vocab_pad_to=0,
        vision_tokens=min(cfg.vision_tokens, 16) if cfg.vision_tokens else 0,
        remat=False,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 256),
        )
        kw["num_dense_layers"] = min(cfg.num_dense_layers, 1)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=128, kv_lora_rank=64,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 32), head_dim=32,
            chunk_size=32,
        )
    if cfg.shared_attn_period:
        kw["shared_attn_period"] = 1
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    if cfg.mrope_sections:
        # sections sum to head_dim//2
        kw["mrope_sections"] = (8, 12, 12)
    kw.update(overrides)
    return cfg.replace(**kw)


@dataclass(frozen=True)
class ConvLayerSpec:
    kind: str                     # conv | maxpool | flatten | dense | relu | lrn
    out_channels: int = 0
    kernel: int = 0
    stride: int = 1
    padding: int = 0
    features: int = 0             # dense width


@dataclass(frozen=True)
class CNNConfig:
    name: str
    layers: Tuple[ConvLayerSpec, ...]
    num_classes: int
    input_hw: Tuple[int, int] = (224, 224)
    input_channels: int = 3
    dtype: str = "float32"
    citation: str = ""
