"""qwen2-7b [arXiv:2407.10671]: 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, QKV bias, rope theta 1e6."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation="silu_glu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="[arXiv:2407.10671] Qwen2 Technical Report, 7B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
