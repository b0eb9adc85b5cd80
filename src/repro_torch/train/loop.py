"""Training loop on the synthetic stream: the JAX package's
``train/loop.py`` without its checkpointing, which comes with the torch
``Checkpointer`` (ROADMAP A.4): asking for it raises."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.data.loader import Loader
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step


def train_loop(model: Model, *, batch: int, seq_len: int, steps: int,
               opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
               log_every: int = 10, log_fn: Callable = print,
               checkpointer=None, ckpt_every: int = 0, full_every: int = 0,
               params=None, opt_state=None, start_step: int = 0,
               resume_from: Optional[int] = None, restore_specs=None,
               restore_coords: Optional[dict] = None, restore_sched=None):
    """Train on the synthetic stream. Returns (params, opt_state, history),
    history holding {"step", "loss", "grad_norm", "t"} every ``log_every``
    steps and at the last. Without ``params`` the model's fp32 masters are
    drawn from ``seed`` on its device. ``checkpointer``, ``ckpt_every``,
    ``full_every``, ``resume_from`` and the ``restore_*`` options are the
    reference's and raise NotImplementedError until ROADMAP A.4 lands."""
    wanted = {"checkpointer": checkpointer is not None,
              "ckpt_every": bool(ckpt_every), "full_every": bool(full_every),
              "resume_from": resume_from is not None,
              "restore_specs": restore_specs is not None,
              "restore_coords": restore_coords is not None,
              "restore_sched": restore_sched is not None}
    if any(wanted.values()):
        raise NotImplementedError(
            f"train_loop: {sorted(k for k, v in wanted.items() if v)}: "
            "checkpointing and resume are not ported yet (ROADMAP.md A.4)")
    opt_cfg = opt_cfg or AdamWConfig()
    if params is None:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        params = model.init(gen, dtype=getattr(torch, model.cfg.param_dtype))
    if opt_state is None:
        opt_state = adamw_init(params)

    step_fn = make_train_step(model, opt_cfg)
    loader = Loader(SyntheticStream(model.cfg.vocab_size, seed), batch,
                    seq_len, model.device)
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, start_step + steps):
        params, opt_state, metrics = step_fn(params, opt_state, loader(step))
        if (step - start_step) % log_every == 0 or step == start_step + steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "t": time.perf_counter() - t0})
            log_fn(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}")
    return params, opt_state, history
