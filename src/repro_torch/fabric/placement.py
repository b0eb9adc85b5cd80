"""Placement — how durable (DFS) data maps onto physical stripe files.

Three strategies, all sharing the striped chunk/unit layout of
``repro_torch.dfs.striped`` for the *data* files (the on-disk data layout is
byte-identical across strategies, so switching placement never rewrites
readers):

* ``striped``      — today's layout, nothing extra.  A lost physical
  stripe file is a loud ``StripeMissingError`` (operator repairs the
  replica), exactly the pre-fabric behaviour.
* ``replicated``   — each data stripe file is mirrored ``replicas``
  times into other DataNode groups; a lost/truncated primary falls over
  to a replica (storage cost x(1+replicas), zero read overhead).
* ``erasure``      — Reed-Solomon over GF(256): ``k = width`` data files
  plus ``m`` parity files (Cauchy-systematic, see repro_torch.fabric.gf256).
  Parity is computed *byte-wise at identical file offsets*, so
  reconstructing any byte range of a lost file reads only the SAME
  range from k survivors — no stripe-row alignment, no full-file reads.
  Storage cost x(1+m/k); degraded reads cost k x the missing range.

Erasure placement also records a CRC per 1 MB chunk of every data and
parity file, so a *corrupted* stripe payload (bad bytes, right length)
is detected at read time and reconstructed like a missing chunk instead
of being returned as tensor bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

STRIPED = "striped"
REPLICATED = "replicated"
ERASURE = "erasure"


@dataclass(frozen=True)
class Placement:
    """Declarative placement config (writer input) and, once written,
    the layout record the reader decodes (``to_attrs``/``from_attrs``)."""

    kind: str = STRIPED
    replicas: int = 1          # replicated: mirror copies per data file
    parity: int = 2            # erasure: m parity files
    verify: bool = True        # erasure: CRC-check chunks on read
    # replicated: place each mirror a whole REGION stride away from its
    # data file (HdfsCluster.num_regions partitions the DataNode groups
    # into region tiers), so losing an entire region's groups still
    # leaves a full copy elsewhere and a remote region's restore reads
    # its own region-local mirror instead of crossing the WAN.  With
    # num_regions == 1 this is a no-op (the classic adjacent-group
    # mirror layout).
    region_spread: bool = False

    # filled in by the writer at close():
    replica_files: tuple = ()  # per data file: ((group, name), ...)
    parity_files: tuple = ()   # ((group, name), ...)
    file_lengths: tuple = ()   # physical data-file lengths (bytes)
    parity_length: int = 0
    chunk_crc: dict = field(default_factory=dict)
    # {"data": [[crc per chunk] per file], "parity": [[...] per file]}

    def __post_init__(self):
        if self.kind not in (STRIPED, REPLICATED, ERASURE):
            raise ValueError(
                f"unknown placement kind {self.kind!r}: expected "
                f"'{STRIPED}', '{REPLICATED}' or '{ERASURE}'")
        if self.kind == REPLICATED and self.replicas < 1:
            raise ValueError("replicated placement needs replicas >= 1")
        if self.kind == ERASURE and self.parity < 1:
            raise ValueError("erasure placement needs parity >= 1")

    # ----- constructors -------------------------------------------------

    @classmethod
    def striped(cls) -> "Placement":
        return cls(kind=STRIPED)

    @classmethod
    def replicated(cls, replicas: int = 1, *,
                   region_spread: bool = False) -> "Placement":
        return cls(kind=REPLICATED, replicas=replicas,
                   region_spread=region_spread)

    @classmethod
    def erasure(cls, parity: int = 2, *, verify: bool = True) -> "Placement":
        return cls(kind=ERASURE, parity=parity, verify=verify)

    @classmethod
    def parse(cls, spec) -> "Placement":
        """Accept a Placement, a kind string, or None (-> striped)."""
        if spec is None:
            return cls.striped()
        if isinstance(spec, Placement):
            return spec
        if isinstance(spec, str):
            return cls(kind=spec)
        raise TypeError(f"cannot interpret placement spec {spec!r}")

    # ----- attrs serialization (namenode metadata) ----------------------

    def to_attrs(self) -> Optional[dict]:
        """Attrs payload, or ``None`` for plain striping — the striped
        layout's metadata stays byte-identical to the pre-fabric format."""
        if self.kind == STRIPED:
            return None
        out = {"kind": self.kind}
        if self.kind == REPLICATED:
            out["replicas"] = self.replicas
            out["region_spread"] = self.region_spread
            out["replica_files"] = [list(map(list, fs))
                                    for fs in self.replica_files]
        else:
            out["parity"] = self.parity
            out["verify"] = self.verify
            out["parity_files"] = [list(f) for f in self.parity_files]
            out["file_lengths"] = list(self.file_lengths)
            out["parity_length"] = self.parity_length
            out["chunk_crc"] = self.chunk_crc
        return out

    @classmethod
    def from_attrs(cls, raw: Optional[dict]) -> "Placement":
        if not raw:
            return cls.striped()
        if raw["kind"] not in (REPLICATED, ERASURE):
            # corrupt metadata or a newer writer: fail at open time with
            # the real reason, not mid-read with a bogus "unrecoverable"
            raise ValueError(
                f"unknown placement kind {raw['kind']!r} in file attrs")
        if raw["kind"] == REPLICATED:
            return cls(
                kind=REPLICATED, replicas=raw.get("replicas", 1),
                region_spread=raw.get("region_spread", False),
                replica_files=tuple(
                    tuple(tuple(f) for f in fs)
                    for fs in raw.get("replica_files", [])))
        return cls(
            kind=ERASURE, parity=raw.get("parity", 2),
            verify=raw.get("verify", True),
            parity_files=tuple(tuple(f) for f in raw.get("parity_files", [])),
            file_lengths=tuple(raw.get("file_lengths", [])),
            parity_length=raw.get("parity_length", 0),
            chunk_crc=raw.get("chunk_crc", {}))
