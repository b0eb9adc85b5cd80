"""Batch loaders: turn the synthetic stream into (tokens, labels) batches on
the training device (``Loader``), or on a mesh, each rank holding its rows
(``ShardedLoader``, the JAX package's, which ``device_put``s the batch with
the step's input sharding). Each call is a ``data.load`` span."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.profiler import span
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
        with span("data.load"):
            raw = self.stream.batch(step, self.batch, self.seq_len)
            return {name: torch.from_numpy(np.ascontiguousarray(part)).to(
                        self.device)
                    for name, part in (("tokens", raw[:, :-1]),
                                       ("labels", raw[:, 1:]))}


class ShardedLoader:
    """The global batch as DTensors over ``rules``' mesh: each rank takes
    its rows over the data axes (the batch dim's ``act_btd`` spec,
    replicated when the batch does not divide them) and is replicated over
    ``model``: the rows the reference's ``device_put`` gives each device's
    shard. Every rank draws the same global batch from the stream."""

    def __init__(self, stream: SyntheticStream, rules, batch: int,
                 seq_len: int, device: torch.device | str | None = None):
        self.stream = stream
        self.rules = rules
        self.batch = batch
        self.seq_len = seq_len
        self.spec = (rules.act_btd(batch)[0], None)
        if device is None:
            from repro_torch.models.model import _mesh_device
            device = _mesh_device(rules.mesh)
        self.device = torch.device(device)

    def __call__(self, step: int) -> dict:
        with span("data.load"):
            raw = self.stream.batch(step, self.batch, self.seq_len)
            mine = self.rules.local_slices((self.batch, self.seq_len),
                                           self.spec)
            out = {}
            for name, part in (("tokens", raw[:, :-1]),
                               ("labels", raw[:, 1:])):
                local = torch.from_numpy(np.ascontiguousarray(part[mine]))
                out[name] = self.rules.from_local(local.to(self.device),
                                                  self.spec, part.shape)
            return out
