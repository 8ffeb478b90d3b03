"""qwen1.5-4b [hf:Qwen/Qwen1.5-0.5B family card]: 40L d_model=2560
20H (kv=20) d_ff=6912 vocab=151936, QKV bias, rope theta 1e6
(family-wide scaled base; 4B shape per the assignment)."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    activation="silu_glu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="[hf:Qwen/Qwen1.5-0.5B] Qwen1.5 model card family, 4B shape",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
