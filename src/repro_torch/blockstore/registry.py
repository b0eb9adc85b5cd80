"""Container registry: content-addressed block store + manifests.

Serves block fetches with an optional ``ThrottleModel`` so benchmarks can
reproduce the registry-hot-spot behaviour of §3.4 (1,000+ concurrent pulls
overwhelming the source); tests run unthrottled.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

from repro_torch.blockstore.image import ImageManifest
from repro_torch.dfs.hdfs import ThrottleModel


class Registry:
    def __init__(self, root: str | Path,
                 throttle: Optional[ThrottleModel] = None):
        self.root = Path(root)
        (self.root / "blocks").mkdir(parents=True, exist_ok=True)
        (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        self.throttle = throttle
        self._lock = threading.Lock()
        self.stats = {"block_requests": 0, "bytes_served": 0,
                      "unique_blocks_served": 0}
        self._served_hashes: set[str] = set()

    def _block_path(self, h: str) -> Path:
        d = self.root / "blocks" / h[:2]
        return d / h

    # ----- blocks -----

    def has_block(self, h: str) -> bool:
        return self._block_path(h).exists()

    def put_block(self, h: str, data: bytes):
        p = self._block_path(h)
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(data)

    def get_block(self, h: str) -> bytes:
        data = self._block_path(h).read_bytes()
        with self._lock:
            self.stats["block_requests"] += 1
            self.stats["bytes_served"] += len(data)
            if h not in self._served_hashes:
                self._served_hashes.add(h)
                self.stats["unique_blocks_served"] += 1
        if self.throttle:
            with self.throttle:
                self.throttle.charge(len(data))
        return data

    # ----- manifests -----

    def put_manifest(self, man: ImageManifest):
        (self.root / "manifests" / f"{man.digest}.json").write_text(
            man.to_json())
        (self.root / "manifests" / f"{man.name.replace('/', '_')}.latest"
         ).write_text(man.digest)

    def get_manifest(self, name_or_digest: str) -> ImageManifest:
        byname = self.root / "manifests" / \
            f"{name_or_digest.replace('/', '_')}.latest"
        digest = byname.read_text() if byname.exists() else name_or_digest
        raw = (self.root / "manifests" / f"{digest}.json").read_text()
        return ImageManifest.from_json(raw)
