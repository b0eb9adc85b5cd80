"""Serving driver: a batched serving session with the ServeEngine (prefill
+ decode over a shared ring cache).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-370m --requests 6 --new-tokens 16 \
        --workdir /tmp/port_serve

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. The model is the arch's reduced (tiny) variant. With
``--workdir`` the params live in a checkpoint in a striped DFS under
``<workdir>/hdfs``, as in the JAX driver: the first run seeds it from
``Model.init`` (seed 0), and every run serves through
``ServeEngine.from_checkpoint`` (the planned restore at CRITICAL). Without
it the engine serves ``Model.init``'s weights directly. BootSeer's managed
startup around it is not part of this one yet (ROADMAP A.2).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_tiny
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m", choices=list(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="serve the params of a checkpoint under "
                         "<workdir>/hdfs, seeded on first use")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_tiny(args.arch)
    model = Model(cfg, device=args.device)
    if args.workdir is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
        engine = ServeEngine(model, params, batch=args.batch,
                             cache_len=args.cache_len, device=model.device)
    else:
        root = Path(args.workdir)
        ck = Checkpointer(HdfsCluster(root / "hdfs", num_groups=8,
                                      block_size=1 << 20),
                          f"/serve_ckpt/{args.arch}")
        if ck.latest_step() is None:
            gen = torch.Generator(device=model.device).manual_seed(0)
            ck.save(0, model.init(gen))
            print("serve params: seeded checkpoint step 0")
        engine = ServeEngine.from_checkpoint(model, ck, batch=args.batch,
                                             cache_len=args.cache_len)
        print(f"serve params: planned restore of step {ck.latest_step()}, "
              f"{ck.timings['wave0_bytes']} bytes")

    rng = np.random.default_rng(0)
    todo = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        rng.integers(3, 12)).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=0.7 if i % 2 else 0.0)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = 0
    while todo:
        batch_reqs = todo[:args.batch]
        todo = todo[args.batch:]
        out = engine.generate(batch_reqs)
        for r in out[:len(batch_reqs)]:
            done += len(r.generated)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "CPU")
    print(f"served {args.requests} requests, {done} tokens "
          f"in {dt:.2f}s ({done / dt:.1f} tok/s on {where}, {cfg.name})")


if __name__ == "__main__":
    main()
