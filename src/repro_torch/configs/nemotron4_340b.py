"""nemotron-4-340b [arXiv:2402.16819 / 2406.11704]: 96L d_model=18432
96H (GQA kv=8) d_ff=73728, squared-ReLU (non-gated) MLP, vocab=256000,
head_dim=192."""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="sq_relu",
    rope_theta=10_000.0,
    citation="[arXiv:2402.16819] Nemotron-4 340B",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
