"""LR schedules: cosine-with-warmup and WSD (warmup-stable-decay), as the
JAX package's ``optim/schedule.py``, in fp32 on the step's device."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor_frac * peak_lr + (1 - floor_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, floor_frac: float = 0.0) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
    dec = peak_lr * (1 - (1 - floor_frac) * prog)
    return torch.where(step < warmup, warm,
                       torch.where(step < warmup + stable, peak_lr, dec))
