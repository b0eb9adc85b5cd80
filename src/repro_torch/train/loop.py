"""Training loop on the synthetic stream with periodic checkpoints through
the striped DFS (``repro_torch.ckpt``): the JAX package's ``train/loop.py``
without its tuning profile (ROADMAP A.8), on one device or on the model's
mesh (one process per device)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.core.profiler import span
from repro_torch.data.loader import Loader, ShardedLoader
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step


def train_loop(*args, **kwargs):
    """``_train_loop`` (its arguments and result) as one ``loop`` span,
    the root of a restart's spans; inside it ``loop.tail_wait`` covers the
    kernels' build and the wait for the restored optimizer state."""
    with span("loop"):
        return _train_loop(*args, **kwargs)


def _train_loop(model: Model, *, batch: int, seq_len: int, steps: int,
                opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
                log_every: int = 10, log_fn: Callable = print,
                checkpointer=None, ckpt_every: int = 0, full_every: int = 0,
                params=None, opt_state=None, start_step: int = 0,
                resume_from: Optional[int] = None, restore_specs=None,
                restore_coords: Optional[dict] = None, restore_sched=None):
    """Train on the synthetic stream. Returns (params, opt_state, history),
    history holding {"step", "loss", "grad_norm", "t"} every ``log_every``
    steps and at the last. Without ``params`` the model's fp32 masters are
    drawn from ``seed`` on its device.

    ``checkpointer`` with ``ckpt_every`` saves params and optimizer state
    after every ``ckpt_every``-th step; with ``full_every`` every
    ``full_every``-th save of the run is full and those between are deltas
    against the save before. ``resume_from`` restores that step and trains
    from it: the params first (wave 0, at CRITICAL under
    ``restore_sched``), then the optimizer state as a DEFERRED tail that
    streams while the params are copied to the device and the kernels are
    built. ``params`` and ``opt_state`` then only name the trees (meta
    tensors of the model's schema when omitted); no random init is drawn.
    ``restore_specs`` (PartitionSpec-like trees for params and optimizer
    state) and ``restore_coords`` plan a partial restore; on one device
    they restore whole tensors. On a mesh the restore reads this rank's
    slices, at its own ``coords_of_rank(rank)`` unless ``restore_coords``
    names others: the reference runs one process for all devices and
    plans with rank 0's coordinates, the port one process per device.

    Options that cannot act raise ValueError: ``resume_from``, ``ckpt_every``
    or ``full_every`` without a checkpointer (the run would silently train
    from scratch, or never save), ``full_every`` without ``ckpt_every``, and
    ``restore_*`` without ``resume_from``."""
    if resume_from is not None and checkpointer is None:
        raise ValueError(
            f"resume_from={resume_from} requires a checkpointer — without "
            "one the run would silently train from scratch")
    for name, value in (("ckpt_every", ckpt_every),
                        ("full_every", full_every)):
        if value and checkpointer is None:
            raise ValueError(f"{name}={value} requires a checkpointer — "
                             "without one nothing would be saved")
    if full_every and not ckpt_every:
        raise ValueError(f"full_every={full_every} requires ckpt_every")
    for name, value in (("restore_specs", restore_specs),
                        ("restore_coords", restore_coords),
                        ("restore_sched", restore_sched)):
        if value is not None and resume_from is None:
            raise ValueError(f"{name} requires resume_from: there is "
                             "nothing to restore")
    if checkpointer is not None and not all(
            hasattr(checkpointer, m)
            for m in ("save", "save_delta", "restore_planned")):
        raise TypeError("checkpointer needs save, save_delta and "
                        "restore_planned (repro_torch.ckpt.Checkpointer)")
    opt_cfg = opt_cfg or AdamWConfig()
    param_dtype = getattr(torch, model.cfg.param_dtype)

    opt_tail = None
    if resume_from is not None:
        if params is None:
            params = model.init_like(dtype=param_dtype)
        if opt_state is None:
            opt_state = adamw_init(params)
        specs = None if restore_specs is None else tuple(restore_specs)
        if model.mesh is not None and restore_coords is None:
            import torch.distributed as dist
            restore_coords = model.rules.coords_of_rank(dist.get_rank())
        params, opt_tail = checkpointer.restore_planned(
            resume_from, params, opt_state, specs=specs,
            coords=restore_coords, async_tail=True, sched=restore_sched,
            device=model.device)
        start_step = resume_from
    else:
        if params is None:
            gen = torch.Generator(device=model.device).manual_seed(seed)
            params = model.init(gen, dtype=param_dtype)
        if opt_state is None:
            opt_state = adamw_init(params)

    step_fn = make_train_step(model, opt_cfg)
    stream = SyntheticStream(model.cfg.vocab_size, seed)
    loader = (Loader(stream, batch, seq_len, model.device)
              if model.mesh is None else
              ShardedLoader(stream, model.rules, batch, seq_len))
    if opt_tail is not None:
        # the tail streams while the kernels build (a no-op once built);
        # the port's step updates params and opt_state in place, so it
        # cannot warm up on the restored trees as the reference does
        with span("loop.tail_wait"):
            if model.device.type == "cuda":
                from repro_torch.kernels import build
                build.build()
            (opt_state,) = opt_tail.result()

    history = []
    saves = 0       # saves this run: every full_every-th one is full
    last_saved: Optional[int] = None
    t0 = time.perf_counter()
    for step in range(start_step, start_step + steps):
        params, opt_state, metrics = step_fn(params, opt_state, loader(step))
        if (step - start_step) % log_every == 0 or step == start_step + steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "t": time.perf_counter() - t0})
            log_fn(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}")
        if checkpointer is not None and ckpt_every and \
                (step + 1) % ckpt_every == 0:
            if full_every and saves % full_every != 0 \
                    and last_saved is not None:
                checkpointer.save_delta(step + 1, params, opt_state,
                                        base=last_saved)
            else:
                checkpointer.save(step + 1, params, opt_state)
            saves += 1
            last_saved = step + 1
    return params, opt_state, history
