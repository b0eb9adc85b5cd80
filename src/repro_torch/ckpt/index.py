"""Checkpoint tensor manifest: name -> (dtype, shape, offset) within the
single logical checkpoint stream stored (striped) in the DFS.

The manifest optionally carries two extensions used by incremental delta
checkpoints (repro_torch.ckpt.delta):

* **per-tensor chunk hashes** — ``hash_chunk`` (chunk granularity in
  bytes) plus ``chunk_hashes[name]`` (CRC32 per chunk of the tensor's
  byte stream).  ``Checkpointer.save_delta`` diffs the new state against
  these to find the byte ranges that changed since the base snapshot
  without re-reading the base data.
* **delta descriptor** — for a delta step, ``delta`` records the base
  step and the ``(logical_offset, length, delta_stream_offset)`` ranges
  the step's ``.delta`` data file actually holds.  A delta step's tensor
  entries are byte-identical to its base's (congruent trees), so the
  logical stream layout never changes along a chain.

Both fields are absent from pre-delta manifests and round-trip as empty —
the JSON format stays readable by and from older checkpoints.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np


@dataclass(frozen=True)
class TensorEntry:
    name: str
    dtype: str
    shape: tuple
    offset: int

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape or (1,))))

    def row_bytes(self) -> int:
        """Bytes of one leading-dim row (for leading-dim sharded reads)."""
        inner = int(np.prod(self.shape[1:] or (1,)))
        return inner * np.dtype(self.dtype).itemsize


class TensorIndex:
    def __init__(self, entries: Iterable[TensorEntry] = (), meta: dict = None):
        self.entries: dict[str, TensorEntry] = {e.name: e for e in entries}
        self.meta = meta or {}
        # delta extensions (see module docstring); absent on old manifests
        self.hash_chunk: Optional[int] = None
        self.chunk_hashes: dict[str, list[int]] = {}
        self.delta: Optional[dict] = None

    @property
    def is_delta(self) -> bool:
        return self.delta is not None

    @property
    def base_step(self) -> Optional[int]:
        return self.delta["base_step"] if self.delta else None

    @property
    def total_bytes(self) -> int:
        # max over end offsets, not offset of the max-offset entry: a
        # zero-byte entry (empty array) can TIE a real tensor's offset and
        # must not shadow its extent
        return max((e.offset + e.nbytes for e in self.entries.values()),
                   default=0)

    def entries_by_offset(self) -> list[TensorEntry]:
        """Entries in stream order — the order restore plans read them."""
        return sorted(self.entries.values(), key=lambda e: e.offset)

    def wave_names(self) -> list[list[str]]:
        """Stream-ordered entry names split into restore waves: tree 0
        (params — they gate model init) first, the remaining trees
        (optimizer state) second."""
        order = self.entries_by_offset()
        first = [e.name for e in order if e.name.startswith("t0")]
        rest = [e.name for e in order if not e.name.startswith("t0")]
        return [w for w in (first, rest) if w]

    def resolve(self, name: str) -> TensorEntry:
        """Look up ``name``, accepting the logical name for entries stored
        with the ``#bf16`` encoding suffix."""
        e = self.entries.get(name) or self.entries.get(name + "#bf16")
        if e is None:
            raise KeyError(f"missing tensor {name}")
        return e

    def add(self, name: str, dtype, shape) -> TensorEntry:
        e = TensorEntry(name=name, dtype=str(np.dtype(dtype)),
                        shape=tuple(int(s) for s in shape),
                        offset=self.total_bytes)
        self.entries[name] = e
        return e

    def to_json(self) -> str:
        d = {
            "meta": self.meta,
            "tensors": [
                {"name": e.name, "dtype": e.dtype, "shape": list(e.shape),
                 "offset": e.offset}
                for e in sorted(self.entries.values(), key=lambda e: e.offset)
            ]}
        if self.hash_chunk is not None:
            d["hash_chunk"] = self.hash_chunk
            d["chunk_hashes"] = self.chunk_hashes
        if self.delta is not None:
            d["delta"] = self.delta
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "TensorIndex":
        d = json.loads(raw)
        idx = cls((TensorEntry(name=t["name"], dtype=t["dtype"],
                               shape=tuple(t["shape"]), offset=t["offset"])
                   for t in d["tensors"]), meta=d.get("meta", {}))
        idx.hash_chunk = d.get("hash_chunk")
        idx.chunk_hashes = {k: list(v)
                            for k, v in d.get("chunk_hashes", {}).items()}
        delta = d.get("delta")
        if delta is not None:
            delta = dict(delta,
                         ranges=[tuple(r) for r in delta.get("ranges", [])])
        idx.delta = delta
        return idx
