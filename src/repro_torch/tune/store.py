"""DFS persistence for tuning profiles (pay tuning once per cluster).

Layout under the mount (alongside the env-cache snapshots):

    tune/profiles/<sha256-digest>.json   — immutable, content-addressed
    tune/HEAD                            — the current digest (pointer)

``publish`` writes the blob then flips HEAD; ``fetch`` reads HEAD, then
the blob, and re-validates version + digest through
``TuningProfile.from_json`` — a corrupt or version-skewed artifact
returns None (callers keep defaults) instead of poisoning a boot.

All reads/writes run under an ``IOScheduler`` "dfs" slot token when the
store has a scheduler (profiles are restored as DEFERRED work — they
must never queue ahead of a critical-path pread), and the bytes land in
``HdfsCluster`` accounting via the mount's write/pread primitives.
Hand the store a *sched-less* mount: the store holds its own tokens, so
a metered mount would double-count the same bytes.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from repro_torch.tune.profile import ProfileError, TuningProfile

HEAD_PATH = "tune/HEAD"
BLOB_DIR = "tune/profiles"


class ProfileStore:
    def __init__(self, mount, *, sched=None, priority: Optional[int] = None):
        self.mount = mount
        self.sched = sched
        # default priority is DEFERRED, resolved lazily: importing
        # repro_torch.core.pipeline at module scope would close an import
        # cycle (core/__init__ -> bootseer -> repro_torch.tune -> here)
        if priority is None and sched is not None:
            from repro_torch.core.pipeline import DEFERRED
            priority = DEFERRED
        self.priority = priority
        self.stats = {"publishes": 0, "fetches": 0, "hits": 0,
                      "rejects": 0, "bytes_read": 0, "bytes_written": 0}

    @contextmanager
    def _slot(self, nbytes: int, priority=None):
        if self.sched is None:
            yield
            return
        prio = self.priority if priority is None else priority
        with self.sched.slot("dfs", priority=prio, nbytes=nbytes):
            yield

    # ----- publish -----

    def publish(self, profile: TuningProfile, *, priority=None) -> dict:
        """Upload ``profile`` and flip HEAD to its digest."""
        raw = profile.to_json()
        digest = profile.digest()
        head = digest.encode()
        with self._slot(len(raw) + len(head), priority):
            self.mount.write(f"{BLOB_DIR}/{digest}.json", raw)
            self.mount.write(HEAD_PATH, head)
        self.stats["publishes"] += 1
        self.stats["bytes_written"] += len(raw) + len(head)
        return {"digest": digest, "bytes": len(raw)}

    # ----- fetch -----

    def fetch(self, *, priority=None) -> Optional[TuningProfile]:
        """The current profile, or None when absent/invalid.  Validation
        failures count in ``stats["rejects"]`` and NEVER raise — a bad
        artifact must not turn a warm boot into a crash."""
        self.stats["fetches"] += 1
        try:
            if not self.mount.exists(HEAD_PATH):
                return None
            with self.mount.open(HEAD_PATH) as fh:
                with self._slot(len(fh), priority):
                    digest = fh.read().decode().strip()
            blob = f"{BLOB_DIR}/{digest}.json"
            if not self.mount.exists(blob):
                self.stats["rejects"] += 1
                return None
            with self.mount.open(blob) as fh:
                with self._slot(len(fh), priority):
                    raw = fh.read()
            self.stats["bytes_read"] += len(raw) + len(digest)
            prof = TuningProfile.from_json(raw)
        except ProfileError:
            self.stats["rejects"] += 1
            return None
        except Exception:  # noqa: BLE001 - DFS unavailable, decode, ...
            self.stats["rejects"] += 1
            return None
        if prof.digest() != digest:
            # HEAD points at a blob whose content drifted from its name
            self.stats["rejects"] += 1
            return None
        prof.store = self
        self.stats["hits"] += 1
        return prof
