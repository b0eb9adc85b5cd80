"""mamba2-370m — attention-free SSD (state-space duality) [arXiv:2405.21060].

vocab 50280 is padded to 50432 (divisible by 256) for TP sharding — standard
practice (GPT-NeoX does the same); recorded in DESIGN.md §5.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

VOCAB_RAW = 50280
VOCAB_PADDED = 50432  # next multiple of 256

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=VOCAB_PADDED,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
)
