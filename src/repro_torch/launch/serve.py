"""Serving launcher with BootSeer-managed startup, the port of the JAX
package's ``launch/serve.py``: the runtime boots the job, then a batched
serving run with the ServeEngine (prefill + decode over a shared ring
cache) serves the params of a checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch mamba2-370m --requests 6 --new-tokens 16 \\
        --workdir /tmp/port_serve

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. Like the training launcher, restarts are warm: the image's
hot-block record and the env cache (on the card, the kernel library)
survive in the workdir, so a second invocation starts faster, the paper's
many-short-jobs workload. The model is the arch's reduced (tiny) variant,
or with ``--full`` its published config. Its params live in a checkpoint
in the workdir's striped DFS: the first run seeds it from ``Model.init``
(seed 0), and every run serves through ``ServeEngine.from_checkpoint``
under the runtime's I/O scheduler at CRITICAL. Without ``--workdir`` the
job lives in a temporary directory that is deleted at exit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_tiny
from repro_torch.core.bootseer import BootseerRuntime, JobSpec
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.launch.boot import (IMAGE, STARTUP_READS, ensure_image,
                                     environment, init_card, io_bytes,
                                     kernel_launches, load_kernels,
                                     nvcc_builds, registry, report_startup)
from repro_torch.models.model import Model, resolve_device
from repro_torch.serve.engine import Request, ServeEngine


def _cpu_env_setup(target: Path, rank: int) -> None:
    """The JAX launcher's stand-in install."""
    time.sleep(0.08)
    (target / "serving_deps.py").write_text("x")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the arch's published config, not its tiny one")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--workdir", default=None,
                    help="the job's registry, DFS and runtime state, and "
                         "the params checkpoint, seeded on first use "
                         "(default: a temporary directory)")
    ap.add_argument("--no-bootseer", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"launcher: serving {args.arch} on {device}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = args.workdir is None
    root = Path(tempfile.mkdtemp(prefix="port_serve-") if scratch
                else args.workdir)
    root.mkdir(parents=True, exist_ok=True)
    try:
        _serve(args, device, root)
    finally:
        if scratch:
            shutil.rmtree(root, ignore_errors=True)


def _serve(args, device: torch.device, root: Path) -> None:
    t_start = time.perf_counter()
    reg = registry(root)
    ensure_image(root, reg)
    hdfs = HdfsCluster(root / "hdfs", num_groups=8, block_size=1 << 20)
    on_card = device.type == "cuda"
    env_setup, job_params = environment(
        on_card, {"arch": args.arch, "mode": "serve"}, _cpu_env_setup)
    spec = JobSpec(
        job_id=f"serve-{args.arch}", image=IMAGE, num_nodes=args.nodes,
        job_params=job_params, startup_reads=STARTUP_READS,
        env_setup=env_setup)
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=root / "rt",
                         optimize=not args.no_bootseer)
    try:
        print("== startup ==", flush=True)
        res = rt.run_startup(spec)
        report_startup(rt, res, prefix="startup ")
        if on_card:
            load_kernels(rt, res)
            init_card(device)

        cfg = get_config(args.arch) if args.full else get_tiny(args.arch)
        model = Model(cfg, device=device)
        ck = Checkpointer(hdfs, f"/serve_ckpt/{args.arch}")
        if ck.latest_step() is None:
            gen = torch.Generator(device=model.device).manual_seed(0)
            ck.save(0, model.init(gen))
            print("serve params: seeded checkpoint step 0", flush=True)
        engine = ServeEngine.from_checkpoint(
            model, ck, batch=args.batch, cache_len=args.cache_len,
            sched=rt.io_sched)
        print(f"serve params: planned restore of step {ck.latest_step()}, "
              f"{ck.timings['wave0_bytes']} bytes", flush=True)

        prefill = engine._prefill

        def first_prefill(*a, **kw):
            # the first token is the argmax of these logits: say when
            # they reach the host
            engine._prefill = prefill
            logits, cache = prefill(*a, **kw)
            logits.cpu()
            print(f"first token {time.perf_counter() - t_start:.2f}s "
                  "after the launcher started", flush=True)
            return logits, cache

        engine._prefill = first_prefill
        rng = np.random.default_rng(0)
        todo = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                            rng.integers(3, 12))
                        .astype(np.int32),
                        max_new_tokens=args.new_tokens,
                        temperature=0.7 if i % 2 else 0.0)
                for i in range(args.requests)]
        served = list(todo)
        t0 = time.perf_counter()
        done = prefills = 0
        while todo:
            batch_reqs = todo[:args.batch]
            todo = todo[args.batch:]
            out = engine.generate(batch_reqs)
            prefills += 1
            for r in out[:len(batch_reqs)]:
                done += len(r.generated)
        if on_card:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rt.drain_deferred()
    finally:
        rt.close()
    where = torch.cuda.get_device_name(device) if on_card else "CPU"
    print(f"served {args.requests} requests, {done} tokens "
          f"in {dt:.2f}s ({done / dt:.1f} tok/s on {where}, {cfg.name})")
    print("boot-end: " + json.dumps({
        "io_bytes": io_bytes(rt), "nvcc_builds": nvcc_builds(),
        "launches": kernel_launches(), "prefills": prefills,
        "greedy_tokens": [r.generated for r in served
                          if r.temperature == 0.0]}), flush=True)


if __name__ == "__main__":
    main()
