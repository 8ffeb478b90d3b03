"""zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 layers (d_model=2048,
ssm_state=64) + ONE shared transformer block (32H attention + 8192 MLP)
applied every 6 mamba layers. The per-invocation LoRA deltas on the shared
block are simplified to a single shared block (DESIGN.md §7)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    activation="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    shared_attn_period=6,
    citation="[arXiv:2411.15242] Zamba2 suite, 1.2B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
