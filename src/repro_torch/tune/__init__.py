"""Launch profiles and tuning-profile persistence, the light part of the
JAX package's ``tune/`` that ``core/bootseer.py`` imports at module top.
The autotune sweep and its pruning are ROADMAP A.8.
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
