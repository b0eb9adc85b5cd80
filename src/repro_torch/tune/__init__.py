"""Kernel autotuning and launch profiles: a port of the JAX package's
``tune/``.

Light imports only: ``core/bootseer.py`` pulls profile/store/launch
symbols from here and must not load torch; the sweep itself
(``repro_torch.tune.autotune``) and its pruning (``prune``) import torch
and are loaded lazily.
"""

from repro_torch.tune.launchprofile import (LaunchProfile,  # noqa: F401
                                            capture_launch_profile,
                                            profile_drift)
from repro_torch.tune.profile import (PROFILE_VERSION,  # noqa: F401
                                      ProfileError, TuningProfile,
                                      attention_key, get_active_profile,
                                      set_active_profile, shape_bucket,
                                      ssd_key, use_profile)
from repro_torch.tune.store import ProfileStore  # noqa: F401


def __getattr__(name):
    if name in ("autotune", "prune"):
        import importlib
        return importlib.import_module(f"repro_torch.tune.{name}")
    raise AttributeError(
        f"module 'repro_torch.tune' has no attribute {name!r}")
