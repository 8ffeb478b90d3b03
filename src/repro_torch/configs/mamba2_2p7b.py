"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L, d_model=2560, attention-free, vocab=50280, ssm_state=128.
Mamba2 defaults: expand=2 (d_inner=5120), head_dim=64 (80 SSD heads),
d_conv=4, 1 B/C group, chunked SSD scan. Vocab padded to a multiple of 128
for even "model"-axis sharding (50280 -> 50304).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
    vocab_size=50280,
    vocab_pad_to=128,
    attention="none",
    rope_mode="none",
    causal=True,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    citation="[arXiv:2405.21060] Transformers are SSMs (Mamba-2), 2.7B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
