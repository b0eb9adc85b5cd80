"""Training driver: AdamW on the synthetic stream, the training half of the
JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2.5-3b --steps 8

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. The model is the arch's reduced (tiny) variant with fp32
master parameters drawn from seed 0. The port trains the dense family
only. BootSeer's managed startup (image load, environment setup, model
init through the runtime) and the periodic striped checkpoints with their
warm resume, which the JAX driver runs around training, are not part of
this one yet (ROADMAP A.4).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_tiny
from repro_torch.models.model import Model
from repro_torch.train.loop import train_loop


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(get_tiny(args.arch), device=args.device)
    _, _, hist = train_loop(model, batch=args.batch, seq_len=args.seq_len,
                            steps=args.steps)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "CPU")
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({model.cfg.name} on {where})")


if __name__ == "__main__":
    main()
