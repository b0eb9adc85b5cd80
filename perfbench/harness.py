"""One run of one cell: found by name from ``BENCHMARK.json``, its
configuration, traffic, limits and metric readers found by name from files
under ``perfbench/``.

    configs/<config>.json   the model configuration as it is run
    traffic/<traffic>.json  the job: its ``kind`` (a module under
                            ``perfbench/kinds/``) and that kind's parameters
    limits/<cell>.json      the limits of the numbers that decide
                            ``correct``, with the readings they were set from
    metrics/<metric>.py     ``read(run)``: the metric's value, or None when
                            the run has nothing for it to read

A run: set-up (the program built from the configuration, weights and
inputs drawn from the seed, every shape warmed up), the measured window of
``seconds``, with ``trace`` two short traced windows after it, then the
comparison with the plain reference once the program's state is freed.
The last line on standard output is the result.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import typing
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints the result,
# compared by their top-level names
BARRED = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise RunError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that this cell
    reports: those listing it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    if s is None or not path.exists():
        raise RunError(f"metric {name!r} has no reader at {path}")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def kind_module(kind: str):
    return importlib.import_module(f"perfbench.kinds.{kind}")


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: its keys that
    are the dataclass's fields, each as the field's type: a group as the
    dataclass the field holds (``ssm``, ``moe``), a list as a tuple."""
    from repro_torch.configs.base import ModelConfig
    hints = typing.get_type_hints(ModelConfig)
    return ModelConfig(**{f.name: _as_field(hints[f.name], cfg[f.name])
                          for f in dataclasses.fields(ModelConfig)
                          if f.name in cfg})


def _as_field(hint, value):
    """A JSON value as a field of type ``hint`` takes it."""
    if isinstance(value, dict):
        for t in typing.get_args(hint) or (hint,):
            if dataclasses.is_dataclass(t):
                return t(**value)
    if isinstance(value, list) and typing.get_origin(hint) is tuple:
        return tuple(value)
    return value


def launches() -> dict:
    """The program's kernel wrappers' launch counters, by wrapper."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    wrappers = (fa.flash_attention, fa.flash_attention_bwd,
                fa.flash_attention_bwd_deterministic, ssd.ssd_chunked_kernel,
                ssd.ssd_chunked_bwd_kernel, ssd.ssd_chunked_kernel_bf16,
                ssd.ssd_chunked_bwd_kernel_bf16)
    return {w.__name__: w.launches for w in wrappers}


def barred_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BARRED))


class Run:
    """What a metric's reader reads: the cell, its configuration and
    traffic, the window's counts and times (``window``), set-up's seconds
    (``setup_s``) and, in a traced run, two traced windows after the
    measured one (``yardstick.Trace``s, else None): ``trace``, the device's
    timeline, traced without the operators' shapes at little cost to the
    host, and ``ops``, the operators with their shapes and the device time
    inside each (the kernels' durations do not move with the host's
    tracing cost)."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int):
        self.cell, self.cfg, self.traffic, self.seed = cell, cfg, traffic, seed
        self.window: dict = {}
        self.trace = None
        self.ops = None
        self.setup_s = None


def process_age() -> float:
    """Seconds since this process started, from /proc (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def profiled(fn, cuda: bool = True, shapes: bool = True):
    """``fn()`` under ``torch.profiler`` (the host's operators and spans,
    the device's activity), between two synchronisations; with ``shapes``
    the operators' input shapes too, which slow the host by about 40% in a
    training step (6% without them, on an H100 host). Returns (its
    result, the events, the host seconds of the traced window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities, record_shapes=shapes) as prof:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    return out, prof.events(), window_s


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", cfg_override: dict | None = None,
             traffic_override: dict | None = None, limits: dict | None = None,
             age0: float = 0.0, t0: float | None = None) -> dict:
    """One run; returns the result's object. ``device``, the overrides and
    ``limits`` exist for the CPU tests, which run a shrunken configuration
    on the CPU's plain kernels: the command line always runs on the
    card."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    bench = spec()
    cell = cell_of(bench, workload)
    chips = int(cell.get("chips", 1))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell asks for {chips} cards, "
                           f"{torch.cuda.device_count()} present")
    cfg = dict(load_json("configs", f"{cell['config']}.json"),
               **(cfg_override or {}))
    traffic = dict(load_json("traffic", f"{cell['traffic']}.json"),
                   **(traffic_override or {}))
    if limits is None:
        limits = load_json("limits", f"{workload}.json")["limits"]
    run = Run(cell, cfg, traffic, seed)
    job = kind_module(traffic["kind"]).Job(run, device=device)
    try:
        return _measure(run, job, bench, workload, seconds, trace, limits,
                        device, chips, age0, t0)
    finally:
        job.close()


def _measure(run, job, bench, workload, seconds, trace, limits, device,
             chips, age0, t0) -> dict:
    import torch
    from perfbench import check, yardstick
    cuda = device == "cuda"
    job.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = age0 + time.perf_counter() - t0
    run.window = job.window(seconds)
    run.window["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                                else None)
    if trace:
        # the timeline at little cost to the host, then the operators
        units, events, window_s = profiled(job.traced, cuda, shapes=False)
        run.trace = yardstick.Trace(events, window_s, units)
        before = launches()
        units, events, window_s = profiled(job.traced, cuda, shapes=True)
        run.ops = yardstick.Trace(events, window_s, units)
        per = {k: (v - before[k]) / units for k, v in launches().items()
               if v > before[k]}
        print(f"launches per {job.unit}: {per}", file=sys.stderr)
    memory_peak = max(setup_peak,
                      torch.cuda.max_memory_allocated() if cuda else 0)
    metrics = {}
    for m in metrics_for(bench, workload,
                         "per_layer" if trace else "end_to_end"):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    program = job.readings()
    job.free()
    correct, shown = check.verdict(check.numbers(program, job.reference()),
                                   limits)
    # after the comparison too: whatever the run loaded up to its result
    barred = barred_modules()
    if barred:
        raise RunError("modules barred from the run are loaded: "
                       + ", ".join(barred))
    result = {"correct": correct, "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else device),
                         "count": chips, "memory_peak_bytes": memory_peak}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = shown
    return result


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output
    (a number that is not finite written as a string)."""
    for c in result["check"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    print(f"check correct {result['correct']}", file=err)
    err.flush()
    print(json.dumps(result, allow_nan=False), file=out)
    out.flush()
