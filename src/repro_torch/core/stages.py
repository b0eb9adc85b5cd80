"""The startup stage model (BootSeer §2.2, Fig. 2).

Scheduler Phase (no GPU resources consumed): RESOURCE_QUEUE, RESOURCE_ALLOC.
Worker Phase (GPU-consuming — the true overhead): IMAGE_LOAD, ENV_SETUP,
MODEL_INIT.  TRAINING marks the end of startup.

Stages marked ``sync`` require a barrier: every worker must finish the stage
before any worker proceeds — the straggler amplification mechanism of §3.3.
"""

from __future__ import annotations

import enum


class Stage(str, enum.Enum):
    RESOURCE_QUEUE = "resource_queue"
    RESOURCE_ALLOC = "resource_alloc"
    IMAGE_LOAD = "image_load"
    ENV_SETUP = "env_setup"
    MODEL_INIT = "model_init"
    TRAINING = "training"


# canonical execution order
STAGE_ORDER: tuple[Stage, ...] = (
    Stage.RESOURCE_QUEUE, Stage.RESOURCE_ALLOC, Stage.IMAGE_LOAD,
    Stage.ENV_SETUP, Stage.MODEL_INIT, Stage.TRAINING)

# stages that actively burn GPU-hours (the machines are allocated)
GPU_CONSUMING: frozenset = frozenset(
    {Stage.IMAGE_LOAD, Stage.ENV_SETUP, Stage.MODEL_INIT})

# stages ending in a cross-node synchronization barrier (Fig. 2 "(Sync)")
SYNC_STAGES: frozenset = frozenset(
    {Stage.IMAGE_LOAD, Stage.ENV_SETUP, Stage.MODEL_INIT})


# ----------------------------------------------------------------------
# fine-grained startup tasks (the pipelined DAG of core/pipeline.py).
# Each coarse Worker-Phase stage decomposes into tasks whose REAL data
# dependencies are narrower than the stage barriers: env.restore and
# ckpt.params_wave depend only on DFS availability, so under the
# pipelined executor they start at t=0 and overlap the image fetch.
# ----------------------------------------------------------------------

class StartupTask:
    IMAGE_HOT_PREFETCH = "image.hot_prefetch"
    IMAGE_STARTUP_READS = "image.startup_reads"
    IMAGE_COLD_STREAM = "image.cold_stream"      # deferred (non-gating)
    ENV_RESTORE = "env.restore"
    ENV_INSTALL = "env.install"
    CKPT_PARAMS_WAVE = "ckpt.params_wave"
    CKPT_OPT_WAVE = "ckpt.opt_wave"              # deferred (non-gating)
    TUNE_RESTORE = "tune.restore"                # deferred (non-gating)


# task -> the coarse §2.2 stage it is profiled under
TASK_STAGE: dict = {
    StartupTask.IMAGE_HOT_PREFETCH: Stage.IMAGE_LOAD,
    StartupTask.IMAGE_STARTUP_READS: Stage.IMAGE_LOAD,
    StartupTask.IMAGE_COLD_STREAM: Stage.IMAGE_LOAD,
    StartupTask.ENV_RESTORE: Stage.ENV_SETUP,
    StartupTask.ENV_INSTALL: Stage.ENV_SETUP,
    StartupTask.CKPT_PARAMS_WAVE: Stage.MODEL_INIT,
    StartupTask.CKPT_OPT_WAVE: Stage.MODEL_INIT,
    StartupTask.TUNE_RESTORE: Stage.MODEL_INIT,
}
