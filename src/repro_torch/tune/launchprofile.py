"""Validated launch profiles: the host-level env knobs that must
survive a restart.

Step time on the card hides outside the kernels too: tcmalloc via
``LD_PRELOAD``, which card the process sees, which CUDA toolkit's
``nvcc`` built the kernel library, cuBLAS's workspace setting (bitwise
determinism needs ``:4096:8``), the caching allocator's configuration
and a TF32 override that changes every fp32 GEMM. A launch profile
captures those variables at env-snapshot creation time
(``EnvCache.create`` stores it in the snapshot meta), and every later
boot diffs the live environment against it: drift lands in
``StartupResult.notes["launch_profile_drift"]``.

Kept import-light on purpose (stdlib only): ``core/bootseer.py`` uses
it at module top, and importing the runtime must not load torch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

LAUNCH_PROFILE_VERSION = 1

# the knobs worth pinning across restarts: allocator, card, toolkit,
# cuBLAS determinism, the caching allocator, TF32
TRACKED_ENV_VARS = (
    "LD_PRELOAD",                      # tcmalloc / allocator interposer
    "CUDA_VISIBLE_DEVICES",
    "CUDA_HOME",                       # whose nvcc built the kernels
    "CUBLAS_WORKSPACE_CONFIG",         # deterministic cuBLAS
    "PYTORCH_CUDA_ALLOC_CONF",
    "NVIDIA_TF32_OVERRIDE",
)


@dataclass
class LaunchProfile:
    """Snapshot of the tracked launch env vars (None = was unset)."""

    env: dict = field(default_factory=dict)
    version: int = LAUNCH_PROFILE_VERSION

    def to_json(self) -> dict:
        return {"version": self.version, "env": dict(self.env)}

    @classmethod
    def from_json(cls, doc: dict) -> "LaunchProfile":
        if not isinstance(doc, dict) \
                or doc.get("version") != LAUNCH_PROFILE_VERSION:
            raise ValueError(
                f"unsupported launch profile: {doc!r}")
        env = doc.get("env")
        if not isinstance(env, dict):
            raise ValueError("launch profile env is not a dict")
        return cls(env=dict(env))


def capture_launch_profile(environ=None,
                           tracked=TRACKED_ENV_VARS) -> LaunchProfile:
    env = os.environ if environ is None else environ
    return LaunchProfile(env={var: env.get(var) for var in tracked})


def profile_drift(profile, environ=None) -> list:
    """Human-readable drift lines between ``profile`` (a LaunchProfile
    or its ``to_json`` dict) and the live environment.  Empty list =
    no drift.  An unparseable profile reports itself as drift instead
    of raising — boot paths must keep booting.  Every value compares
    exactly: ``LD_PRELOAD``'s order decides which library interposes."""
    env = os.environ if environ is None else environ
    if isinstance(profile, dict):
        try:
            profile = LaunchProfile.from_json(profile)
        except ValueError as e:
            return [f"invalid launch profile: {e}"]
    return [f"{var}: snapshot {want!r} != current {have!r}"
            for var, want in profile.env.items()
            if want != (have := env.get(var))]
