"""BootSeer's startup stages and the priority-aware I/O scheduler that
checkpoint restores run under (copies of the JAX package's
``core/stages.py`` and ``core/pipeline.py``). The profiler and the startup
runtime come with the rest of the startup half (ROADMAP.md A.2).
"""

from repro_torch.core.stages import Stage, STAGE_ORDER, GPU_CONSUMING, SYNC_STAGES  # noqa: F401
from repro_torch.core.pipeline import CRITICAL, DEFERRED, IOScheduler  # noqa: F401
