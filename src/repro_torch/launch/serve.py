"""Serving driver: a batched serving session with the ServeEngine (prefill
+ decode over a shared ring cache), on random weights from ``Model.init``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-370m --requests 6 --new-tokens 16

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. The model is the arch's reduced (tiny) variant. BootSeer's
managed startup and the checkpoint restore of the JAX driver are not part
of this one yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_tiny
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
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_tiny(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params, batch=args.batch,
                         cache_len=args.cache_len, device=model.device)

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
