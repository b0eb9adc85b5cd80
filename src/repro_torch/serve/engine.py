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
from torch.distributed.tensor import DTensor

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
                 cache_len: int, device: torch.device | str = "cuda",
                 tune_profile=None):
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
        # kernel launch configs for this replica: installed as the ambient
        # profile around generate(), so the prefill and decode steps'
        # kernels resolve tuned tiles instead of defaults
        self.tune_profile = tune_profile
        self._prefill = make_prefill(model, batch, cache_len)
        self._decode = make_decode_step(model, batch, cache_len)

    @classmethod
    def from_checkpoint(cls, model: Model, checkpointer, step=None, *,
                        batch: int, cache_len: int, sched=None,
                        priority=None, tune_store=None) -> "ServeEngine":
        """An engine whose params come from a checkpoint, params only (no
        optimizer wave is planned or read), through the planned restore at
        CRITICAL (``priority``) under ``sched``: params gate the time to
        first token. ``step`` defaults to the latest restorable one. The
        restored leaves (fp32 masters or a serving tree) are cast as
        ``Model.serving_params`` casts them.

        ``tune_store``: a ``repro_torch.tune.store.ProfileStore`` — the
        replica fetches the cluster's TuningProfile (tiny, metered,
        DEFERRED by the store's own default priority: it never gates the
        time to first token), so a serving cold start inherits the tuned
        kernel configs with zero re-tuning; a missing or corrupt profile
        keeps the defaults."""
        from repro_torch.core.pipeline import CRITICAL
        if step is None:
            step = checkpointer.latest_step()
            if step is None:
                raise FileNotFoundError(
                    "from_checkpoint: no checkpoint steps found under "
                    f"{checkpointer.base!r}")
        (params,) = checkpointer.restore_planned(
            step, model.init_like(), sched=sched,
            priority=CRITICAL if priority is None else priority,
            device=model.device)
        tune_profile = tune_store.fetch() if tune_store is not None \
            else None
        return cls(model, model.serving_params(params), batch=batch,
                   cache_len=cache_len, device=model.device,
                   tune_profile=tune_profile)

    def generate(self, requests: list[Request], seed: int = 0) -> list[Request]:
        if self.tune_profile is None:
            return self._generate(requests, seed)
        from repro_torch.tune.profile import use_profile
        with use_profile(self.tune_profile):
            return self._generate(requests, seed)

    def _generate(self, requests: list[Request], seed: int) -> list[Request]:
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
        """The next token of each row. On a mesh the vocab-sharded logits
        are gathered first, and every rank draws the same tokens from its
        own generator of the same seed."""
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        logits = logits.float().cpu()
        out = np.argmax(logits.numpy(), axis=-1).astype(np.int32)
        for i, r in enumerate(requests):
            if r.temperature > 0:
                p = torch.softmax(logits[i] / r.temperature, dim=-1)
                out[i] = int(torch.multinomial(p, 1, generator=gen))
        return out
