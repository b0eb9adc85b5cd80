"""What both launchers do around ``BootseerRuntime.run_startup``: the
synthetic container image, the job's environment, the report of a boot,
and loading the kernel library from the environment the runtime set up.

On the card the job's one real startup dependency is the kernel library:
``env_setup`` builds it with ``nvcc`` into the node's environment
(``<target>/kernels``), rank 0's ``env.install`` snapshots it into the env
cache, and a warm restart restores it instead of building. The cache key
carries the sources' hash, so a changed source never restores an old
library. On the CPU there are no kernels, and the environment is the JAX
launchers' stand-in install, so both packages compute the same cache key.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.blockstore.image import build_image
from repro_torch.blockstore.registry import Registry
from repro_torch.core.bootseer import BootseerRuntime, StartupResult
from repro_torch.core.stages import Stage
from repro_torch.dfs.hdfs import ThrottleModel
from repro_torch.kernels import build

BS = 64 * 1024
IMAGE = "train-image"
# the container's startup file accesses: the image's hot set
STARTUP_READS = [("bin/python", 0, -1), ("libframework.so", 0, -1)]
KERNELS_DIR = "kernels"


def registry(root: Path) -> Registry:
    """The job's container registry, throttled as in the JAX launchers."""
    return Registry(root / "registry", throttle=ThrottleModel(
        bandwidth=3e7, per_stream=2e6, timescale=1.0))


def ensure_image(root: Path, reg: Registry) -> None:
    try:
        reg.get_manifest(IMAGE)
        return
    except FileNotFoundError:
        pass
    src = root / "image_src"
    (src / "bin").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    (src / "bin" / "python").write_bytes(
        rng.integers(0, 256, 8 * BS, dtype=np.uint8).tobytes())
    (src / "libframework.so").write_bytes(
        rng.integers(0, 256, 12 * BS, dtype=np.uint8).tobytes())
    (src / "assets.tar").write_bytes(
        rng.integers(0, 256, 32 * BS, dtype=np.uint8).tobytes())
    build_image(src, reg, IMAGE, block_size=BS)


def environment(on_card: bool, job_params: dict,
                cpu_setup: Callable) -> tuple[Callable, dict]:
    """The job's ``(env_setup, job_params)``: on the card the kernel
    library built into ``<target>/kernels`` and its sources' hash in the
    cache key; on the CPU ``cpu_setup`` and ``job_params`` as given."""
    if not on_card:
        return cpu_setup, job_params

    def env_setup(target: Path, rank: int) -> None:
        build.build(directory=target / KERNELS_DIR)

    return env_setup, {**job_params, "kernels": build.source_hash()}


def env_target(rt: BootseerRuntime, res: StartupResult,
               rank: int = 0) -> Path:
    """Node ``rank``'s environment directory in the run ``res`` (the
    layout of ``BootseerRuntime._node_tasks``)."""
    return (rt.workdir / f"{res.job_id}_r{res.run_idx}" / f"n{rank}"
            / "site-packages")


def load_kernels(rt: BootseerRuntime, res: StartupResult) -> None:
    """Load the kernel library from node 0's environment, where the
    runtime built or restored it, and say which library it is."""
    t0 = time.perf_counter()
    lib = build.build(directory=env_target(rt, res) / KERNELS_DIR)
    sha = hashlib.sha256(lib.path.read_bytes()).hexdigest()
    print(f"kernels: {lib.path.name} loaded from "
          f"{lib.path.parent.relative_to(rt.workdir)} in "
          f"{time.perf_counter() - t0:.2f}s, sha256 {sha}", flush=True)


def init_card(device: torch.device) -> None:
    """Create the process's CUDA context now, and say how long it took,
    so that it is not counted in what the launcher times after it."""
    t0 = time.perf_counter()
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    print(f"card: CUDA context in {time.perf_counter() - t0:.2f}s",
          flush=True)


def report_restore(timings: dict) -> None:
    """The restore's parts, from ``Checkpointer.timings``."""
    t = {k: timings.get(k, 0.0) for k in (
        "wave0_bytes", "wave0_read_s", "wave0_alloc_s", "wave0_copy_s",
        "tail_bytes", "tail_s")}
    print(f"restore: wave 0 {t['wave0_bytes'] / 1e9:.2f} GB read in "
          f"{t['wave0_read_s']:.2f}s (allocation {t['wave0_alloc_s']:.2f}s, "
          f"last copy waited {t['wave0_copy_s']:.2f}s), tail "
          f"{t['tail_bytes'] / 1e9:.2f} GB in {t['tail_s']:.2f}s", flush=True)


def report_startup(rt: BootseerRuntime, res: StartupResult,
                   prefix: str = "  ") -> None:
    """The JAX launchers' stage lines, then one ``boot: {json}`` line with
    each stage's slowest node, the total, node 0's critical path, the
    scheduler's bytes so far and the nvcc builds the env stage ran."""
    stages = {st.value: max(d.get(st.value, 0.0)
                            for d in res.node_stage_s.values())
              for st in (Stage.IMAGE_LOAD, Stage.ENV_SETUP, Stage.MODEL_INIT)}
    for name, s in stages.items():
        print(f"{prefix}{name:<12} {s:6.2f}s")
    print(f"{prefix}TOTAL        {res.total_s:6.2f}s "
          f"({'warm' if res.notes.get('prefetch_used') else 'cold'})")
    attr = res.notes["critical_path"].get("node000", {})
    print("boot: " + json.dumps({
        "stages_s": stages, "total_s": res.total_s,
        "prefetch_used": res.notes["prefetch_used"],
        "critical_path": attr.get("chain", []),
        "tasks_s": {k: v["s"] for k, v in attr.get("tasks", {}).items()},
        "gating_counts": res.notes["gating_counts"],
        "io_bytes": io_bytes(rt),
        "nvcc_builds": nvcc_builds()}), flush=True)


def io_bytes(rt: BootseerRuntime) -> dict:
    """{resource: {"critical": bytes, "deferred": bytes}} the runtime's
    scheduler has metered so far (empty for the baseline runtime)."""
    if rt.io_sched is None:
        return {}
    return {res: {p: st["bytes"][p] for p in ("critical", "deferred")}
            for res, st in rt.io_sched.snapshot().items()}


def nvcc_builds() -> list:
    """[(library name, seconds)] of every nvcc build in this process."""
    return [(p.name, round(s, 3)) for p, s in build.builds]


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
    from repro_torch.kernels.ssd import (
        ssd_chunked_bwd_kernel, ssd_chunked_bwd_kernel_bf16,
        ssd_chunked_kernel, ssd_chunked_kernel_bf16)
    from repro_torch.kernels.unembed_ce import ce_fold_kernel, ce_grad_kernel
    return {fn.__name__: fn.launches
            for fn in (flash_attention, flash_attention_bwd,
                       flash_attention_bwd_deterministic, ssd_chunked_kernel,
                       ssd_chunked_bwd_kernel, ssd_chunked_kernel_bf16,
                       ssd_chunked_bwd_kernel_bf16, ce_fold_kernel,
                       ce_grad_kernel)}
