"""Versioned, content-addressed kernel tuning profiles (a copy of the JAX
package's ``tune/profile.py``).

A :class:`TuningProfile` maps ``(kernel, shape-bucket, dtype, backend)``
keys to validated launch configs.  Shapes are bucketed to the next power
of two so one tuned entry serves the whole bucket.

Profiles are the unit of persistence (``repro_torch.tune.store``): the
canonical-JSON payload is content-addressed by sha256, and both the
format version and the digest are re-checked on load, so a corrupted or
version-skewed artifact is rejected (``ProfileError``) instead of
silently steering kernels with garbage configs.

The *ambient* profile is a process-wide slot that ``use_profile`` scopes
for tests, serving engines and training loops; ``kernels/ops.py``
resolves the card kernels' launch configs from it, and the BootSeer
runtime's ``tune.restore`` task installs the one it fetched or swept
(``repro_torch.tune.autotune``).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from contextlib import contextmanager
from typing import Optional

PROFILE_VERSION = 1


class ProfileError(ValueError):
    """A profile artifact failed validation (version skew, digest
    mismatch, malformed payload).  Callers fall back to defaults."""


def shape_bucket(n: int) -> int:
    """Next power of two >= ``n`` (floor 16): the shape-bucket axis of a
    profile key.  Kernels clamp blocks to the real length, so bucketed
    configs stay legal across the whole bucket."""
    n = max(int(n), 1)
    b = 16
    while b < n:
        b *= 2
    return b


def attention_key(*, sq: int, sk: int, d: int, g: int, dtype: str,
                  causal: bool, window: int, backend: str) -> str:
    """Profile key for ``flash_attention``: shape-bucketed sequence
    lengths, exact head_dim and GQA group size, masking mode, dtype,
    backend."""
    win = shape_bucket(window) if window > 0 else 0
    return (f"flash_attention|sq{shape_bucket(sq)}|sk{shape_bucket(sk)}"
            f"|d{d}|g{g}|c{int(bool(causal))}|w{win}|{dtype}|{backend}")


def ssd_key(*, s: int, h: int, p: int, g: int, n: int, dtype: str,
            backend: str) -> str:
    """Profile key for ``ssd_chunked_kernel``."""
    return (f"ssd|s{shape_bucket(s)}|h{h}|p{p}|g{g}|n{n}"
            f"|{dtype}|{backend}")


class TuningProfile:
    """In-memory profile: ``entries[key] = {"config": {...}, ...}``.

    Thread-safe: record/resolve may race between the deferred restore
    task and kernel callers.  ``store`` (optional, set by the runtime)
    lets record-on-miss publish back to the DFS; ``tune_on_miss`` gates
    whether ``repro_torch.kernels.ops`` tunes unseen keys on first use.
    """

    def __init__(self, *, backend: str = "cpu-interpret",
                 version: int = PROFILE_VERSION,
                 created: Optional[float] = None):
        self.version = version
        self.backend = backend
        self.created = time.time() if created is None else created
        self.entries: dict = {}
        self.stats = {"hits": 0, "misses": 0, "ref_fallbacks": 0,
                      "dropped_configs": 0}
        self.store = None
        self.tune_on_miss = False
        self._lock = threading.Lock()

    # ----- record / resolve -----

    def record(self, key: str, config: dict, *, measured_s=None,
               predicted_s=None, verified: bool = True) -> dict:
        entry = {"config": dict(config), "verified": bool(verified)}
        if measured_s is not None:
            entry["measured_s"] = float(measured_s)
        if predicted_s is not None:
            entry["predicted_s"] = float(predicted_s)
        with self._lock:
            self.entries[key] = entry
        return entry

    def resolve(self, key: str) -> Optional[dict]:
        """The tuned config for ``key`` (a copy), or None on miss."""
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                self.stats["misses"] += 1
                return None
            self.stats["hits"] += 1
            return dict(entry["config"])

    def note(self, counter: str, n: int = 1) -> None:
        """Bump a profile stat (e.g. ``ref_fallbacks`` when ops falls
        back to the reference path and the tuned config is dropped)."""
        with self._lock:
            self.stats[counter] = self.stats.get(counter, 0) + n

    # ----- serialization (content-addressed) -----

    def payload(self) -> dict:
        with self._lock:
            entries = {k: dict(v) for k, v in self.entries.items()}
        return {"version": self.version, "backend": self.backend,
                "created": self.created, "entries": entries}

    @staticmethod
    def _digest_of(payload: dict) -> str:
        canon = json.dumps(payload, sort_keys=True,
                           separators=(",", ":")).encode()
        return hashlib.sha256(canon).hexdigest()

    def digest(self) -> str:
        return self._digest_of(self.payload())

    def to_json(self) -> bytes:
        payload = self.payload()
        return json.dumps({"payload": payload,
                           "digest": self._digest_of(payload)},
                          sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "TuningProfile":
        """Parse + validate.  Raises :class:`ProfileError` on anything
        suspect — boot paths catch it and keep the defaults."""
        try:
            doc = json.loads(raw.decode())
            payload = doc["payload"]
            digest = doc["digest"]
        except Exception as e:  # noqa: BLE001 - any malformed artifact
            raise ProfileError(f"malformed tuning profile: {e!r}") from e
        if cls._digest_of(payload) != digest:
            raise ProfileError("tuning profile digest mismatch "
                               "(corrupt or tampered artifact)")
        if payload.get("version") != PROFILE_VERSION:
            raise ProfileError(
                f"tuning profile version {payload.get('version')!r} != "
                f"supported {PROFILE_VERSION}")
        prof = cls(backend=payload.get("backend", "cpu-interpret"),
                   created=payload.get("created"))
        entries = payload.get("entries")
        if not isinstance(entries, dict):
            raise ProfileError("tuning profile entries are not a dict")
        for key, entry in entries.items():
            cfg = entry.get("config") if isinstance(entry, dict) else None
            if not isinstance(cfg, dict) \
                    or not all(isinstance(v, int) and v > 0
                               for v in cfg.values()):
                raise ProfileError(
                    f"tuning profile entry {key!r} has a non-positive or "
                    "non-integer launch config")
            prof.entries[key] = dict(entry)
        return prof


# ---------------------------------------------------------------------------
# ambient profile (consulted by repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: Optional[TuningProfile] = None


def set_active_profile(profile: Optional[TuningProfile]):
    """Install ``profile`` as the ambient profile; returns the previous
    one so callers can restore it."""
    global _active
    with _active_lock:
        prev, _active = _active, profile
    return prev


def get_active_profile() -> Optional[TuningProfile]:
    with _active_lock:
        return _active


@contextmanager
def use_profile(profile: Optional[TuningProfile]):
    """Scoped ambient profile (tests, benchmarks, train/serve loops)."""
    prev = set_active_profile(profile)
    try:
        yield profile
    finally:
        set_active_profile(prev)
