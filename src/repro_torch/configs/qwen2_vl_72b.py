"""qwen2-vl-72b — VLM backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191].

Only the language backbone is built; the ViT/SigLIP vision tower + projector
is a stub — ``input_specs()`` supplies precomputed patch embeddings plus 3-D
M-RoPE position ids (temporal / height / width).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
    rope_theta=1e6,
)
