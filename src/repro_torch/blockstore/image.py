"""Flattened block-level container image format (BootSeer §4.2 baseline).

Instead of OCI layers, an image is flattened into a single namespace of
files, each mapped to a list of content-addressed 1 MB blocks (giving both
dedup and block-level lazy loading — the paper reports ~10x over OCI with
this alone).  The manifest is JSON keyed by image digest.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

BLOCK_SIZE = 1 * 1024 * 1024


@dataclass
class FileEntry:
    path: str
    size: int
    mode: int
    blocks: list  # list[str] block hashes


@dataclass
class ImageManifest:
    name: str
    block_size: int
    files: list  # list[FileEntry]
    digest: str = ""

    def compute_digest(self) -> str:
        h = hashlib.sha256()
        for f in sorted(self.files, key=lambda f: f.path):
            h.update(f.path.encode())
            h.update(f.size.to_bytes(8, "little"))
            for b in f.blocks:
                h.update(bytes.fromhex(b))
        return h.hexdigest()[:32]

    @property
    def total_size(self) -> int:
        return sum(f.size for f in self.files)

    @property
    def unique_blocks(self) -> set:
        out: set[str] = set()
        for f in self.files:
            out.update(f.blocks)
        return out

    def block_sizes(self) -> dict:
        """hash -> payload bytes (a file's last block may be partial;
        identical hashes are identical content, so collisions agree)."""
        out: dict[str, int] = {}
        for f in self.files:
            for i, h in enumerate(f.blocks):
                if i == len(f.blocks) - 1:
                    out[h] = f.size - i * self.block_size
                else:
                    out[h] = self.block_size
        return out

    @property
    def unique_block_bytes(self) -> int:
        """Total payload of the deduplicated block set — the floor on
        registry egress for one cold image distribution."""
        return sum(self.block_sizes().values())

    def file_map(self) -> dict:
        return {f.path: f for f in self.files}

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "digest": self.digest,
            "block_size": self.block_size,
            "files": [{"path": f.path, "size": f.size, "mode": f.mode,
                       "blocks": f.blocks} for f in self.files]})

    @classmethod
    def from_json(cls, raw: str) -> "ImageManifest":
        d = json.loads(raw)
        return cls(name=d["name"], digest=d["digest"],
                   block_size=d["block_size"],
                   files=[FileEntry(**f) for f in d["files"]])


def _iter_blocks(path: Path, block_size: int) -> Iterable[bytes]:
    with open(path, "rb") as f:
        while True:
            data = f.read(block_size)
            if not data:
                break
            yield data


def build_image(src_dir: str | Path, registry, name: str,
                block_size: int = BLOCK_SIZE) -> ImageManifest:
    """Flatten ``src_dir`` into a block image, pushing (deduplicated) blocks
    into the registry.  Returns the manifest (also stored in the registry)."""
    src = Path(src_dir)
    files: list[FileEntry] = []
    for p in sorted(src.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(src))
        hashes = []
        for blk in _iter_blocks(p, block_size):
            h = hashlib.sha256(blk).hexdigest()
            if not registry.has_block(h):
                registry.put_block(h, blk)
            hashes.append(h)
        files.append(FileEntry(path=rel, size=p.stat().st_size,
                               mode=p.stat().st_mode & 0o777, blocks=hashes))
    man = ImageManifest(name=name, block_size=block_size, files=files)
    man.digest = man.compute_digest()
    registry.put_manifest(man)
    return man
