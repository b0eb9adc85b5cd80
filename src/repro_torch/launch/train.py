"""End-to-end training launcher with BootSeer-managed startup, the port of
the JAX package's ``launch/train.py``.

Runs the worker-phase startup (image load -> env setup -> model init)
through the port's BootSeer runtime with real I/O, then trains the arch
with periodic checkpoints into the striped DFS. Restartable: a second
invocation with the same --workdir resumes from the latest checkpoint via
the warm path (hot-block prefetch, env cache, striped resume).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2.5-3b --steps 8 --ckpt-every 4 --workdir /tmp/port_job

    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --arch qwen2.5-3b --nodes 1 --batch 2 --seq-len 2048 --steps 2 \\
        --ckpt-every 2 --workdir build/boot-train

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. On the card the environment the runtime sets up is the kernel
library: the cold boot's ``env.install`` builds it with nvcc, a warm boot
restores it from the env cache, and the launcher loads it from node 0's
environment before training (``repro_torch.launch.boot``). The model is
the arch's reduced (tiny) variant, or with ``--full`` its published
config, with fp32 master parameters drawn from seed 0: the dense family
(attention through the flash kernels on the card), the SSM family
(``--arch mamba2-370m``: the SSD scan through its forward and backward
kernels) or the hybrid (``--arch zamba2-1.2b``: both). Every ``--full-every``-th save is full, the ones
between deltas. Without ``--workdir`` the job lives in a temporary
directory that is deleted at exit.

The registry keeps the JAX launcher's throttle. The DFS is not throttled,
unlike the JAX launcher's simulated HDFS (1e9 B/s shared, 2e7 B/s a
stream): a full-width checkpoint is 40.77 GB, which that model would turn
into minutes of sleep, and on the card's machine the disk and page cache
are real. As in the JAX launcher, the runtime reads the checkpoint's bytes
(params at CRITICAL, the optimizer state DEFERRED) and ``train_loop``
then restores the tensors from the same files.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_tiny
from repro_torch.core.bootseer import BootseerRuntime, JobSpec
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.launch.boot import (IMAGE, STARTUP_READS, ensure_image,
                                     environment, init_card, io_bytes,
                                     kernel_launches, load_kernels,
                                     nvcc_builds, registry, report_restore,
                                     report_startup)
from repro_torch.models.model import Model, resolve_device
from repro_torch.train.loop import train_loop


class _LoggedSaves:
    """Prints each save; everything else is the checkpointer's."""

    def __init__(self, ck: Checkpointer):
        self.ck = ck

    def _say(self, step: int, kind: str) -> None:
        t = self.ck.timings
        print(f"  checkpoint @ step {step} ({kind}, "
              f"{t['save_bytes'] / 2**20:.2f} MiB written in "
              f"{t['save_s']:.2f}s, {'striped' if self.ck.striped else 'plain'})",
              flush=True)

    def save(self, step, *trees, **kw):
        out = self.ck.save(step, *trees, **kw)
        self._say(step, "full")
        return out

    def save_delta(self, step, *trees, **kw):
        out = self.ck.save_delta(step, *trees, **kw)
        self._say(step, "delta")
        return out

    def __getattr__(self, name):
        return getattr(self.ck, name)


def _cpu_env_setup(target: Path, rank: int) -> None:
    """The JAX launcher's stand-in install."""
    time.sleep(0.1)
    for i in range(8):
        (target / f"dep{i}.py").write_text(f"v={i}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the arch's published config, not its tiny one")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--regions", type=int, default=1,
                    help="region tier for the swarm: node ranks stripe "
                         "over this many regions (cross-region fetches "
                         "ride the WAN tier exactly once per block)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full-every", type=int, default=0,
                    help="every N-th save full, the others deltas "
                         "(0: all full)")
    ap.add_argument("--workdir", default=None,
                    help="the job's registry, DFS and runtime state; a "
                         "second run resumes from its latest checkpoint "
                         "(default: a temporary directory)")
    ap.add_argument("--no-bootseer", action="store_true",
                    help="baseline startup (no prefetch/env-cache/striping)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"launcher: training {args.arch} on {device}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = args.workdir is None
    root = Path(tempfile.mkdtemp(prefix="port_job-") if scratch
                else args.workdir)
    root.mkdir(parents=True, exist_ok=True)
    try:
        _train(args, device, root)
    finally:
        if scratch:
            shutil.rmtree(root, ignore_errors=True)


def _train(args, device: torch.device, root: Path) -> None:
    reg = registry(root)
    ensure_image(root, reg)
    hdfs = HdfsCluster(root / "hdfs", num_groups=8, block_size=1 << 20)
    ck = Checkpointer(hdfs, striped=not args.no_bootseer, width=8)
    resume = ck.latest_step()
    on_card = device.type == "cuda"
    env_setup, job_params = environment(
        on_card, {"arch": args.arch, "deps": ["framework==2.1"]},
        _cpu_env_setup)
    spec = JobSpec(
        job_id=f"train-{args.arch}", image=IMAGE, num_nodes=args.nodes,
        job_params=job_params, startup_reads=STARTUP_READS,
        env_setup=env_setup, resume_step=resume, resume_plan="rows")

    topology = None
    if args.regions > 1:
        from repro_torch.blockstore.swarm import Topology

        def region_fn(node_id, _n=args.regions):
            digits = "".join(ch for ch in node_id if ch.isdigit())
            return f"region{int(digits or 0) % _n}"

        topology = Topology(region_fn=region_fn)

    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=root / "rt",
                         optimize=not args.no_bootseer, topology=topology)
    try:
        print(f"== startup ({'baseline' if args.no_bootseer else 'BootSeer'}"
              f"{', resume@' + str(resume) if resume else ', cold'}) ==",
              flush=True)
        res = rt.run_startup(spec, checkpointer=ck)
        report_startup(rt, res)
        if on_card:
            load_kernels(rt, res)
            init_card(device)

        print("== training ==", flush=True)
        cfg = get_config(args.arch) if args.full else get_tiny(args.arch)
        model = Model(cfg, device=device)
        print(f"resuming params/opt from step {resume} (planned two-wave "
              "restore)" if resume is not None
              else f"cold start: no checkpoint under {root / 'hdfs'}",
              flush=True)
        _, _, hist = train_loop(
            model, batch=args.batch, seq_len=args.seq_len, steps=args.steps,
            checkpointer=_LoggedSaves(ck), ckpt_every=args.ckpt_every,
            full_every=args.full_every, resume_from=resume,
            log_fn=lambda line: print(line, flush=True))
        if "wave0_bytes" in ck.timings:   # no save has replaced them
            report_restore(ck.timings)
        print(f"first step: {hist[0]['t']:.2f}s", flush=True)
        rt.drain_deferred()   # surface deferred restore/stream failures
    finally:
        rt.close()
    where = (torch.cuda.get_device_name(device) if on_card else "CPU")
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({cfg.name} on {where}, steps {hist[0]['step']}-"
          f"{hist[-1]['step']})")
    print("boot-end: " + json.dumps({
        "io_bytes": io_bytes(rt), "nvcc_builds": nvcc_builds(),
        "launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
