"""Prefill and decode steps for the serving engine. PyTorch runs eagerly,
so there is nothing to compile: each step is the model's entry point for a
fixed batch and cache length, run without autograd."""

from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill(model: Model, batch: int, cache_len: int):
    def prefill(params: dict, batch_in: dict, *,
                unembed: torch.Tensor | None = None):
        tokens = batch_in["tokens"]
        if tokens.shape[0] != batch:
            raise ValueError(f"prefill: batch {tokens.shape[0]} != {batch}")
        with torch.no_grad():
            return model.prefill(params, batch_in, cache_len=cache_len,
                                 unembed=unembed)
    return prefill


def make_decode_step(model: Model, batch: int, cache_len: int):
    want = model.cache_shapes(batch, cache_len)

    def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                    pos: int, *, unembed: torch.Tensor | None = None):
        got = {name: tuple(t.shape) for name, t in caches.items()}
        if tokens.shape != (batch, 1) or got != want:
            raise ValueError(f"decode_step: tokens {tuple(tokens.shape)}, "
                             f"caches {got} do not match batch {batch}, "
                             f"cache_len {cache_len}: {want}")
        with torch.no_grad():
            return model.decode_step(params, tokens, caches, pos,
                                     unembed=unembed)
    return decode_step
