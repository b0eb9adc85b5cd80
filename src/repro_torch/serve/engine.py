"""Batched serving engine: prefill + greedy/temperature decode over a shared
ring KV cache. Counterpart of the JAX package's ``serve/engine.py``; it
keeps the reference's behaviour, quirks included:

* prompts are left-padded with token 0, and the padding is not masked;
* the caller's request list is padded in place to the engine batch;
* the token sampled from the prefill logits is fed to the first decode
  step but is not appended to ``generated``.

Temperature sampling draws from a ``torch.Generator`` seeded from
``seed``; it cannot reproduce ``jax.random``, so the two engines agree on
greedy requests only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.model import Model, resolve_device
from repro_torch.serve.step import make_decode_step, make_prefill


@dataclass
class Request:
    prompt: np.ndarray              # [prompt_len] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: list = field(default_factory=list)


class ServeEngine:
    """Minimal batched engine: pads a request batch to a fixed shape,
    prefills once, then decodes step by step for all sequences together."""

    def __init__(self, model: Model, params: dict, *, batch: int,
                 cache_len: int, device: torch.device | str = "cuda"):
        device = resolve_device(device)
        if device != model.device:
            raise ValueError(f"ServeEngine: device {device} but the model "
                             f"runs on {model.device}")
        self.model = model
        self.params = params
        # the fp32 unembedding table, made once for these weights
        self.unembed = model.unembed_table(params)
        self.batch = batch
        self.cache_len = cache_len
        self.device = device
        self._prefill = make_prefill(model, batch, cache_len)
        self._decode = make_decode_step(model, batch, cache_len)

    def generate(self, requests: list[Request], seed: int = 0) -> list[Request]:
        if len(requests) > self.batch:
            raise ValueError(f"generate: {len(requests)} requests for a "
                             f"batch of {self.batch}")
        while len(requests) < self.batch:
            requests.append(Request(prompt=np.zeros(1, np.int32),
                                    max_new_tokens=0))
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.batch, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        logits, cache = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            unembed=self.unembed)

        gen = torch.Generator().manual_seed(seed)
        max_new = max(r.max_new_tokens for r in requests)
        pos = plen
        nxt = self._sample(logits, requests, gen)
        for step in range(max_new):
            logits, cache = self._decode(
                self.params, torch.from_numpy(nxt)[:, None].to(self.device),
                cache, pos, unembed=self.unembed)
            pos += 1
            nxt = self._sample(logits, requests, gen)
            for i, r in enumerate(requests):
                if step < r.max_new_tokens:
                    r.generated.append(int(nxt[i]))
        return requests

    @staticmethod
    def _sample(logits: torch.Tensor, requests: list[Request],
                gen: torch.Generator) -> np.ndarray:
        logits = logits.float().cpu()
        out = np.argmax(logits.numpy(), axis=-1).astype(np.int32)
        for i, r in enumerate(requests):
            if r.temperature > 0:
                p = torch.softmax(logits[i] / r.temperature, dim=-1)
                out[i] = int(torch.multinomial(p, 1, generator=gen))
        return out
