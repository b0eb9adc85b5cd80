"""moonshot-v1-16b-a3b — fine-grained MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, experts_per_token=6),
    rope_theta=5e4,
)
