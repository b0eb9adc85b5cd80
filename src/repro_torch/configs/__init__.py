"""Architecture config registry.

Every assigned architecture has one module exporting ``CONFIG``; this package
exposes ``get_config(arch_id)``, ``get_tiny(arch_id)`` (smoke-test reduced
variant) and ``ARCHS`` (all ids).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, reduced  # noqa: F401

ARCHS: tuple[str, ...] = (
    "yi-34b",
    "musicgen-large",
    "moonshot-v1-16b-a3b",
    "qwen2.5-3b",
    "zamba2-1.2b",
    "qwen1.5-110b",
    "dbrx-132b",
    "mamba2-370m",
    "qwen2-vl-72b",
    "mixtral-8x22b",
)

_MODULES = {
    "yi-34b": "yi_34b",
    "musicgen-large": "musicgen_large",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2.5-3b": "qwen2_5_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen1.5-110b": "qwen1_5_110b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-370m": "mamba2_370m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mixtral-8x22b": "mixtral_8x22b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; valid: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_tiny(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]
