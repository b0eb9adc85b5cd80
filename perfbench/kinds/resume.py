"""Restarts from a checkpoint, one after the other in one process: each a
fresh model with nothing of the last left on the card, and the program's
loop (``repro_torch.train.loop.train_loop``) resuming a saved step through
its checkpointer over the striped DFS (``repro_torch.ckpt``, ``dfs``) and
training ``steps_per_resume`` steps from it.

Set-up draws a train state (weights, AdamW moments of a run in progress,
the step count ``checkpoint_step``) from the seed and saves it once
through ``Checkpointer.save`` into an ``HdfsCluster`` under ``TMPDIR``
(no throttle: the page cache serves the reads, so the cell measures the
restore machinery, not a disk), then warms up with ``warm_resumes``
restarts. Each restart's loop calls its checkpointer's ``save`` after every
step (``ckpt_every=1``); the harness's checkpointer writes nothing there and
reads, after the first step, the first step's clipped gradient from AdamW's
first moment, (mu_1 - b1 mu_0) / (1 - b1), on the device without waiting
for it. The comparison takes the last restart's losses, that gradient and
each leaf's change over the restart's steps, against the reference trained
from the same state on the same rows. The traffic file gives ``batch``,
``seq_len``, ``optimizer``, ``steps_per_resume``, ``checkpoint_step``,
``moments`` (``mu_std``, ``nu_scale``), ``warm_resumes`` and
``reference_rows``.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from perfbench import generator
from perfbench.check import device_norms, stacked_norms
from perfbench.kinds.train import free_card, no_tf32, update_norms
from perfbench.reference.common import Precision, unstack
from perfbench.reference.train import train_steps


class _Timed:
    """The program's checkpointer with the time at which its restore had
    handed over the parameters and finished the optimizer's tail, and a
    ``save`` that writes nothing: after the restart's first step it hands
    the optimizer state to ``after_first``."""

    def __init__(self, ck, after_first):
        self._ck = ck
        self.ready = None
        self.after_first = after_first
        self.first = None

    def save(self, step, params, opt_state):
        if self.first is None:
            self.first = self.after_first(opt_state)

    def __getattr__(self, name):
        return getattr(self._ck, name)

    def restore_planned(self, *args, **kw):
        with record_function("bench.restore"):
            first, tail = self._ck.restore_planned(*args, **kw)
        done = []
        tail.add_done_callback(lambda _: done.append(time.perf_counter()))
        returned = time.perf_counter()
        self.ready = lambda: max([returned] + done)
        return first, tail


class Job:
    unit = "restart"   # what the traced window counts

    def __init__(self, run, device: str = "cuda"):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.device = torch.device(device)
        self.batch = self.traffic["batch"]
        self.seq = self.traffic["seq_len"]
        self.k = self.traffic["checkpoint_step"]
        self.n = self.traffic["steps_per_resume"]
        self.tmp = None
        self.last = None

    def state(self) -> tuple[dict, dict]:
        """The saved train state, drawn from the seed."""
        params = generator.weights(self.cfg, self.run.seed, self.device)
        mu, nu = self.state_moments()
        return params, {"mu": mu, "nu": nu,
                        "step": torch.tensor(self.k, dtype=torch.int32,
                                             device=self.device)}

    def setup(self) -> None:
        from perfbench.harness import program_config
        from repro_torch.ckpt.checkpoint import Checkpointer
        from repro_torch.dfs.hdfs import HdfsCluster
        from repro_torch.optim.adamw import AdamWConfig
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build()
        self.pcfg = program_config(self.cfg)
        self.opt_cfg = AdamWConfig(**self.traffic["optimizer"])
        self.tmp = Path(tempfile.mkdtemp(prefix="perfbench-resume-"))
        self.ck = Checkpointer(HdfsCluster(self.tmp / "hdfs", throttle=None))
        params, opt = self.state()
        self.ck.save(self.k, params, opt)
        del params, opt
        for _ in range(self.traffic["warm_resumes"]):
            self.resume(keep=False)

    def resume(self, keep: bool) -> dict:
        """One restart; its times. With ``keep`` its trained state and
        losses stay for the comparison."""
        from repro_torch.models.model import Model
        from repro_torch.train.loop import train_loop
        self.last = None
        free_card(self.device)
        model = Model(self.pcfg, device=self.device)
        ck = _Timed(self.ck, self.first_grad)
        marks = []
        t0 = time.perf_counter()
        with record_function("bench.resume"):
            params, opt, hist = train_loop(
                model, batch=self.batch, seq_len=self.seq, steps=self.n,
                opt_cfg=self.opt_cfg, seed=generator.stream_seed(self.run.seed),
                log_every=1, log_fn=lambda _: marks.append(time.perf_counter()),
                checkpointer=ck, ckpt_every=1, resume_from=self.k)
        t = self.ck.timings
        out = {"resume_s": marks[0] - t0, "first_step_s": marks[0] - ck.ready(),
               "wave0_s": t["wave0_read_s"] + t.get("wave0_copy_s", 0.0),
               "tail_s": t["tail_s"],
               "finite": all(math.isfinite(h["loss"]) for h in hist)}
        if keep:
            self.last = (params, ck.first, [h["loss"] for h in hist])
        del params, opt
        return out

    def first_grad(self, opt_state: dict) -> dict:
        """{leaf: 0-d device tensor}: the norm of the first step's clipped
        gradient, (mu_1 - b1 mu_0) / (1 - b1), mu_0 drawn again from the
        seed. Nothing waits for the device."""
        b1 = self.traffic["optimizer"]["b1"]
        mu0 = self.state_moments(nu=False)[0]
        norms = device_norms(opt_state["mu"], mu0, minus_scale=b1,
                             scale=1 / (1 - b1))
        del mu0
        return norms

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        cycles = []
        while not cycles or time.perf_counter() - t0 < seconds:
            cycles.append(self.resume(keep=True))
        window_s = time.perf_counter() - t0
        n = len(cycles)
        out = {"seconds": window_s, "resumes": n, "attempted": n,
               "failed": sum(not c["finite"] for c in cycles)}
        for key in ("resume_s", "first_step_s", "wave0_s", "tail_s"):
            out[key] = sum(c[key] for c in cycles) / n
        return out

    def traced(self) -> int:
        self.resume(keep=True)
        return 1

    def readings(self) -> dict:
        params, first, losses = self.last
        start = generator.weights(self.cfg, self.run.seed, self.device)
        update = stacked_norms(params, start)
        del start
        return {"losses": losses, "update": update,
                "first_grad": {n: float(t) for n, t in first.items()}}

    def state_moments(self, nu: bool = True) -> tuple[dict, dict | None]:
        m = self.traffic["moments"]
        return generator.moments(self.cfg, self.run.seed, self.device,
                                 m["mu_std"], m["nu_scale"], nu=nu)

    def free(self) -> None:
        self.last = None
        free_card(self.device)

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def reference(self, prec: Precision = Precision(),
                  half_batch: bool = False) -> dict:
        """The reference's readings over the restart's steps from the saved
        state, at ``prec``, or with the planted fault ``half_batch``."""
        stream = generator.TokenStream(self.cfg["vocab_size"],
                                       generator.stream_seed(self.run.seed))
        batches = [stream.batch(s, self.batch, self.seq, self.device)
                   for s in range(self.k, self.k + self.n)]
        with no_tf32():
            params, opt = self.state()
            params = unstack(params)
            opt = {"mu": unstack(opt["mu"]), "nu": unstack(opt["nu"]),
                   "step": self.k}
            out = train_steps(self.cfg, params, opt, batches,
                              self.traffic["optimizer"],
                              rows=self.traffic["reference_rows"], prec=prec,
                              half_batch=half_batch)
            del opt
            out["update"] = update_norms(params, unstack(generator.weights(
                self.cfg, self.run.seed, self.device)))
            del params
        free_card(self.device)
        return out
