"""gemma-7b [arXiv:2403.08295]: 28L d_model=3072 16H (kv=16, MHA on 7b;
MQA is the 2b variant) d_ff=24576 GeGLU, head_dim=256, vocab=256000,
tied embeddings scaled by sqrt(d_model)."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    citation="[arXiv:2403.08295] Gemma: Open Models..., 7B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
