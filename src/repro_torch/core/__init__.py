"""BootSeer's primary contribution: the startup profiling system (§4.1) and
the startup orchestrator wiring the three optimizations together (§4.2-4.4),
copies of the JAX package's ``core/`` (``bootseer.py`` without the kernel
tuning task, ROADMAP.md A.8).
"""

from repro_torch.core.stages import Stage, STAGE_ORDER, GPU_CONSUMING, SYNC_STAGES  # noqa: F401
from repro_torch.core.pipeline import CRITICAL, DEFERRED, IOScheduler  # noqa: F401
from repro_torch.core.profiler import (  # noqa: F401
    StageLogger, StageAnalysisService, StageEvent, parse_log)
from repro_torch.core.bootseer import BootseerRuntime, JobSpec, StartupResult  # noqa: F401
