"""A closed loop of training steps: the program's step
(``repro_torch.train.step.make_train_step`` with AdamW over fp32 masters)
taking one step after the other on the rows of the token stream.

Set-up builds the one step object with its model and optimizer state from
the seed's weights and drives it through the first ``check_steps`` steps,
reading what the comparison needs (each step's loss, the first step's
gradient as AdamW holds it, each leaf's change after the last of them),
and hands the same object to the window, which goes on from there. The
traffic file gives ``batch``, ``seq_len``, ``optimizer`` (AdamW's
settings), ``check_steps``, ``trace_steps`` (the traced window's),
``reference_rows`` (the rows the reference takes at a time) and the
token stream's parameters (``stream``).
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from perfbench import generator
from perfbench.check import stacked_norms
from perfbench.reference.common import (Precision, map_tree, named_leaves,
                                        unstack)
from perfbench.reference.train import train_steps


def free_card(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Job:
    unit = "step"   # what the traced window counts

    def __init__(self, run, device: str = "cuda"):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.device = torch.device(device)
        self.batch = self.traffic["batch"]
        self.seq = self.traffic["seq_len"]
        self.stream = generator.stream_for(self.cfg, self.traffic, run.seed)

    # ----- the program -----

    def feed(self, step: int) -> dict:
        tokens, labels = self.stream.batch(step, self.batch, self.seq,
                                           self.device)
        return {"tokens": tokens.contiguous(), "labels": labels.contiguous()}

    def setup(self) -> None:
        from perfbench.harness import program_config
        from repro_torch.models.model import Model
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train.step import make_train_step
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build()
        self.model = Model(program_config(self.cfg), device=self.device)
        opt_cfg = AdamWConfig(**self.traffic["optimizer"])
        self.step_fn = make_train_step(self.model, opt_cfg)
        self.params = generator.weights(self.cfg, self.run.seed, self.device)
        self.opt = adamw_init(self.params)
        losses, first_grad = [], None
        for step in range(self.traffic["check_steps"]):
            self.params, self.opt, m = self.step_fn(self.params, self.opt,
                                                    self.feed(step))
            losses.append(float(m["loss"]))
            if step == 0:   # mu = (1 - b1) g from a zero start
                first_grad = stacked_norms(self.opt["mu"],
                                           scale=1 / (1 - opt_cfg.b1))
        start = generator.weights(self.cfg, self.run.seed, self.device)
        self._readings = {"losses": losses, "first_grad": first_grad,
                          "update": stacked_norms(self.params, start)}
        del start
        self.next = self.traffic["check_steps"]
        free_card(self.device)

    def steps(self, until: float | None = None, count: int | None = None):
        """Steps until ``until`` on the host clock has passed, or ``count``
        of them; each step's loss kept on the device. Returns the losses."""
        losses = []
        while True:
            with record_function("bench.feed"):
                batch = self.feed(self.next)
            with record_function("bench.step"):
                self.params, self.opt, m = self.step_fn(self.params,
                                                        self.opt, batch)
            losses.append(m["loss"])
            self.next += 1
            if count is not None and len(losses) >= count:
                break
            if until is not None and time.perf_counter() >= until:
                break
        return losses

    def window(self, seconds: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = self.steps(until=t0 + seconds)
        with record_function("bench.sync"):
            finite = torch.isfinite(torch.stack(losses)).sum().item()
        window_s = time.perf_counter() - t0
        n = len(losses)
        return {"seconds": window_s, "steps": n,
                "tokens": n * self.batch * self.seq,
                "attempted": n, "failed": n - int(finite)}

    def traced(self) -> int:
        n = self.traffic["trace_steps"]
        losses = self.steps(count=n)
        torch.stack(losses).sum().item()
        return n

    def readings(self) -> dict:
        return self._readings

    def free(self) -> None:
        del self.params, self.opt, self.step_fn, self.model
        free_card(self.device)

    def close(self) -> None:
        pass

    # ----- the reference -----

    def reference_batches(self, first: int, count: int) -> list:
        return [self.stream.batch(s, self.batch, self.seq, self.device)
                for s in range(first, first + count)]

    def start_state(self):
        """(params, optimizer state) the program started from, in the
        reference's layout."""
        params = unstack(generator.weights(self.cfg, self.run.seed,
                                           self.device))
        return params, {"mu": map_tree(torch.zeros_like, params),
                        "nu": map_tree(torch.zeros_like, params), "step": 0}

    def reference(self, prec: Precision = Precision(),
                  half_batch: bool = False) -> dict:
        """The reference's readings over the same steps, at ``prec``, or
        with the planted fault ``half_batch``."""
        steps = self.traffic["check_steps"]
        with no_tf32():
            params, opt_state = self.start_state()
            out = train_steps(self.cfg, params, opt_state,
                              self.reference_batches(0, steps),
                              self.traffic["optimizer"],
                              rows=self.traffic["reference_rows"], prec=prec,
                              half_batch=half_batch)
            del opt_state
            out["update"] = update_norms(params, self.start_state()[0])
            del params
        free_card(self.device)
        return out


def update_norms(params: dict, start: dict) -> dict:
    """{leaf: norm of params - start} over ``named_leaves``."""
    before = dict(named_leaves(start))
    return {n: float(torch.linalg.vector_norm(t - before[n]))
            for n, t in named_leaves(params)}


class no_tf32:
    """float32 products in float32 (TF32 off) while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
