"""mixtral-8x7b [arXiv:2401.04088]: 32L d_model=4096 32H (GQA kv=8),
8 experts top-2 (d_expert=14336), sliding-window attention (4096),
vocab=32000."""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="silu_glu",
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25),
    citation="[arXiv:2401.04088] Mixtral of Experts, 8x7B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
