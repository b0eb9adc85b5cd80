"""Carry parameters across from the JAX package as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import param_schema


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device: torch.device | str,
                      dtype: torch.dtype | None = None) -> dict:
    """The reference's ``Model.init`` tree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameters: the
    same names and shapes, cast once to ``dtype`` (default: ``cfg.dtype``);
    the leaves the reference uses in fp32 (``Leaf.fp32``) stay fp32, bit
    for bit. Raises if a name or shape differs from the port's schema."""
    dtype = dtype or getattr(torch, cfg.dtype)
    schema = param_schema(cfg)

    def convert(sub_schema: dict, sub_tree: dict, where: str) -> dict:
        if set(sub_schema) != set(sub_tree):
            raise ValueError(f"params_from_numpy: {where or 'top level'} has "
                             f"{sorted(sub_tree)}, expected {sorted(sub_schema)}")
        out = {}
        for name, leaf in sub_schema.items():
            if isinstance(leaf, dict):
                out[name] = convert(leaf, sub_tree[name], f"{where}{name}/")
                continue
            arr = np.asarray(sub_tree[name])
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"params_from_numpy: {where}{name} has shape "
                                 f"{arr.shape}, expected {tuple(leaf.shape)}")
            out[name] = torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.float32 if leaf.fp32 else dtype)
        return out

    return convert(schema, tree, "")
