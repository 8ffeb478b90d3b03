"""hubert-xlarge [arXiv:2106.07447]: 48L encoder-only, d_model=1280,
16H (kv=16), d_ff=5120, 504 cluster-unit vocab.

Bidirectional (causal=False), so it has no decode step. The conv waveform
frontend is stubbed, as in the JAX package: a request carries precomputed
frame embeddings (B, S, d_model). HuBERT's conv positional embedding is
adapted to rope-free attention over those frame embeddings."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    causal=False,
    rope_mode="none",
    embeds_input=True,
    citation="[arXiv:2106.07447] HuBERT, X-Large (same arch as w2v2)",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
