"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, experts_per_token=4),
    rope_theta=5e5,
)
