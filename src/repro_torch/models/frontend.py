"""Modality frontend stand-ins: the counterpart of the JAX package's
``models/frontend.py``.

``musicgen-large`` consumes EnCodec frame embeddings; ``qwen2-vl-72b``
consumes ViT patch embeddings and 3-D M-RoPE position ids. The frontends
themselves (the codec, the vision tower) are not built, as in the
reference: these helpers give the shapes the backbone takes and random
stand-ins of them; the decoder backbone that consumes them is the model.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def needs_embeddings(cfg: ModelConfig) -> bool:
    return cfg.arch_type in ("vlm", "audio")


def embedding_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple:
    """``batch["embeddings"]``'s shape; its dtype is fp32."""
    return (batch, seq, cfg.d_model)


def mrope_pos_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple:
    """``batch["mrope_pos"]``'s shape: (temporal, height, width) per token,
    int."""
    return (batch, seq, 3)


def fake_embeddings(cfg: ModelConfig, batch: int, seq: int,
                    generator: torch.Generator,
                    device: torch.device | str) -> torch.Tensor:
    """fp32 standard normal stand-ins, drawn from ``generator`` (which must
    live on ``device``)."""
    return torch.randn(embedding_shape(cfg, batch, seq), generator=generator,
                       device=device, dtype=torch.float32)


def fake_mrope_pos(cfg: ModelConfig, batch: int, seq: int,
                   device: torch.device | str) -> torch.Tensor:
    """Text-like positions: all three streams are the token index."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None, :, None].expand(mrope_pos_shape(cfg, batch, seq))
