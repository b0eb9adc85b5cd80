"""Batch loader: turns the synthetic stream into (tokens, labels) batches on
the training device. The JAX package's ``ShardedLoader`` places them with
the step's input shardings; one device needs no sharding (ROADMAP A.7)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticStream


class Loader:
    def __init__(self, stream: SyntheticStream, batch: int, seq_len: int,
                 device: torch.device | str):
        self.stream = stream
        self.batch = batch
        self.seq_len = seq_len
        self.device = torch.device(device)

    def __call__(self, step: int) -> dict:
        """{"tokens", "labels"}: [batch, seq_len] int32 on the device, the
        stream's row split as raw[:, :-1] / raw[:, 1:]."""
        raw = self.stream.batch(step, self.batch, self.seq_len)
        return {name: torch.from_numpy(np.ascontiguousarray(part)).to(
                    self.device)
                for name, part in (("tokens", raw[:, :-1]),
                                   ("labels", raw[:, 1:]))}
