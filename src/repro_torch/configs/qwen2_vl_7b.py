"""qwen2-vl-7b [arXiv:2409.12191]: qwen2-7b language backbone + M-RoPE
(sections t/h/w = 16/24/24 over head_dim/2 = 64) and dynamic-resolution
vision. The ViT frontend is stubbed, as in the JAX package: a request
carries projected patch embeddings (B, V, d_model) that prefix the text
tokens; M-RoPE itself is fully implemented."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation="silu_glu",
    qkv_bias=True,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision_tokens=1024,          # fixed patch grid per request (stub)
    citation="[arXiv:2409.12191] Qwen2-VL, 7B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
