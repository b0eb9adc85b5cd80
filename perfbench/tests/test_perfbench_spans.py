"""The ``program_span`` metrics on the CPU at a shrunken size: a traced run
of each cell reports its span metrics, each run reads the spans of its
own timeline window, and a program without spans gives no reading."""

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, program_spans  # noqa: E402

SSM = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=32,
           ngroups=1)
MAMBA = dict(num_layers=2, d_model=64, vocab_size=256, ssm=SSM)
TRAFFIC = dict(batch=2, seq_len=64, reference_rows=1, trace_steps=2)
TRAIN, RESUME = "mamba2-370m.train-b16s2048", "mamba2-370m.resume-b16s2048"
SPAN_METRICS = {
    TRAIN: ["step_prepare_host_ms.train", "forward_host_ms.train",
            "backward_host_ms.train", "optimizer_host_ms.train"],
    RESUME: ["tail_wait_s.resume", "restore_alloc_s.resume",
             "first_step_host_s.resume", "load_wait_ms.resume"]}
SEED = 2 ** 31 + 777


def run(cell, seed=SEED, **traffic):
    return harness.run_cell(cell, seed, 0.3, True, device="cpu",
                            cfg_override=MAMBA,
                            traffic_override=dict(TRAFFIC, **traffic))


def test_every_span_metric_is_declared():
    bench = harness.spec()
    declared = {m["name"]: m for m in bench["per_layer"]
                if m["source"] == "program_span"}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            assert declared[name]["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_reports_its_span_metrics(cell):
    metrics = run(cell)["metrics"]
    for name in SPAN_METRICS[cell]:
        assert metrics[name]["value"] > 0, name


def test_two_runs_read_their_own_window():
    """A second run in the process, with another count of traced steps,
    reads the first of its own two traced windows."""
    from repro_torch.core.profiler import spans
    run(TRAIN, trace_steps=2)
    last = max(r.id for r in spans())
    got = run(TRAIN, seed=SEED + 1, trace_steps=3)["metrics"]
    mine = [r for r in spans() if r.id > last]
    roots = [r for r in mine if r.name == "step" and r.parent is None]
    assert len(roots) == 6
    window = {r.id for r in roots[:3]}
    forward = [r for r in mine if r.name == "step.forward"
               and r.trace in window]
    assert len(forward) == 3
    want = 1e3 * sum(map(program_spans.seconds, forward)) / 3
    assert got["forward_host_ms.train"]["value"] == pytest.approx(want,
                                                                  rel=1e-12)


def test_no_spans_no_reading(monkeypatch):
    """Too few roots for two windows, or a program without ``spans``
    (the parent of this metric's change), give None."""
    import repro_torch.core.profiler as profiler
    big = types.SimpleNamespace(trace=types.SimpleNamespace(units=10 ** 6))
    assert program_spans.units(big, "step") is None
    assert program_spans.mean_per_unit(big, "step", "step.forward") is None
    assert program_spans.units(types.SimpleNamespace(trace=None),
                               "step") is None
    monkeypatch.delattr(profiler, "spans")
    one = types.SimpleNamespace(trace=types.SimpleNamespace(units=1))
    assert program_spans.units(one, "step") is None


def test_a_window_that_lost_records_gives_none(monkeypatch):
    """Records dropped to the program's bound leave no reading once the
    oldest kept one ends inside the window (a dropped one may have been
    the window's); dropped from well before it, the window still reads."""
    from collections import deque

    import torch
    import repro_torch.core.profiler as profiler
    from repro_torch.core.profiler import span

    def steps(count):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(count):
                with span("step"), span("step.forward"):
                    pass

    two = types.SimpleNamespace(trace=types.SimpleNamespace(units=2))
    for limit, count, whole in ((8, 4, True), (7, 4, False), (10, 6, True)):
        monkeypatch.setattr(profiler, "SPAN_LIMIT", limit)
        monkeypatch.setattr(profiler, "_span_records", deque(maxlen=limit))
        monkeypatch.setattr(profiler, "_span_dropped", 0)
        steps(count)
        window = program_spans.units(two, "step")
        if whole:
            assert [[r.name for r in u] for u in window] == \
                [["step", "step.forward"]] * 2, (limit, count)
        else:
            assert window is None, (limit, count)
