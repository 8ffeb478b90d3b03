"""deepseek-v3-671b [arXiv:2412.19437]: 61L d_model=7168, MLA attention
(128 heads; q_lora=1536, kv_lora=512, nope/rope head dims 128/64, v=128),
MoE with 1 shared + 256 routed experts top-8 (d_expert=2048, sigmoid
scores), first 3 layers dense (d_ff=18432), MTP depth 1, vocab=129280.

The assignment's "d_ff=2048" is the per-expert hidden dim; the dense
layers use the published 18432. DeepSeek's bias-based aux-free balancing
is approximated with the Switch aux loss (DESIGN.md §7)."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      reduce_for_smoke)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432,
    num_dense_layers=3,
    vocab_size=129280,
    activation="silu_glu",
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.0, score_fn="sigmoid"),
    mtp_depth=1,
    rope_theta=10_000.0,
    citation="[arXiv:2412.19437] DeepSeek-V3, 671B (37B active)",
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
