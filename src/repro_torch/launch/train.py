"""Training driver: AdamW on the synthetic stream with periodic striped
checkpoints and resume, the training half of the JAX package's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2.5-3b --steps 8 --workdir /tmp/port_job --ckpt-every 4

Runs on the CUDA card unless ``--device cpu`` is given, and fails if there
is no card. The model is the arch's reduced (tiny) variant with fp32
master parameters drawn from seed 0. The port trains the dense family
only. With ``--workdir`` it checkpoints params and optimizer state every
``--ckpt-every`` steps into a striped DFS under ``<workdir>/hdfs`` (every
``--full-every``-th save full, the ones between deltas), and a second run
with the same workdir resumes from the latest step, as the JAX driver
does. BootSeer's managed startup around it (image load, environment setup,
the runtime's restore-ahead) is not part of this one yet (ROADMAP A.2).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_tiny
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.models.model import Model
from repro_torch.train.loop import train_loop


class _LoggedSaves:
    """Prints each save; everything else is the checkpointer's."""

    def __init__(self, ck: Checkpointer):
        self.ck = ck

    def _say(self, step: int, kind: str) -> None:
        t = self.ck.timings
        print(f"  checkpoint @ step {step} ({kind}, "
              f"{t['save_bytes'] / 2**20:.2f} MiB written in "
              f"{t['save_s']:.2f}s, {'striped' if self.ck.striped else 'plain'})")

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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint into <workdir>/hdfs and resume from "
                         "its latest step")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full-every", type=int, default=0,
                    help="every N-th save full, the others deltas "
                         "(0: all full)")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(get_tiny(args.arch), device=args.device)
    ckpt_kw: dict = {}
    if args.workdir is not None:
        root = Path(args.workdir)
        root.mkdir(parents=True, exist_ok=True)
        ck = Checkpointer(HdfsCluster(root / "hdfs", num_groups=8,
                                      block_size=1 << 20), width=8)
        resume = ck.latest_step()
        print(f"resuming params/opt from step {resume} (planned two-wave "
              "restore)" if resume is not None
              else f"cold start: no checkpoint under {root / 'hdfs'}")
        ckpt_kw = dict(checkpointer=_LoggedSaves(ck),
                       ckpt_every=args.ckpt_every,
                       full_every=args.full_every, resume_from=resume)
    _, _, hist = train_loop(model, batch=args.batch, seq_len=args.seq_len,
                            steps=args.steps, **ckpt_kw)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "CPU")
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({model.cfg.name} on {where}, steps {hist[0]['step']}-"
          f"{hist[-1]['step']})")


if __name__ == "__main__":
    main()
