"""musicgen-large — decoder-only backbone over EnCodec tokens [arXiv:2306.05284].

Only the transformer backbone is built; the EnCodec / mel frontend is a stub —
``input_specs()`` supplies precomputed frame embeddings (see DESIGN.md).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    rope_theta=1e4,
)
