"""zamba2-1.2b — hybrid: Mamba2 backbone + ONE shared attention block applied
every 6 layers (weights reused each invocation) [arXiv:2411.15242].

Fidelity note (DESIGN.md §5): the released model adds per-invocation LoRA
deltas on the shared weights; we share the raw weights.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
    shared_attention_every=6,
    # the shared attention block's KV is held to a sliding window so that
    # long_500k decode has bounded state (DESIGN.md §5 long_500k).
    sliding_window=4096,
)
