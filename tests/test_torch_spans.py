"""The port's spans (``repro_torch.core.profiler.span``): nothing while no
``torch.profiler`` session records; under one, a ``record_function`` of
the span's name and a record on the trace's clock, nested by context and
kept across the checkpoint's tail thread; the restore's ``timings`` from
the same boundaries; the MoE block's scope names."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs.base import MoEConfig
from repro_torch.core import profiler as prof_mod
from repro_torch.core.profiler import span, spans
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.models import moe
from repro_torch.optim.adamw import adamw_init


def _new(before: list) -> list:
    seen = {r.id for r in before}
    return [r for r in spans() if r.id not in seen]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_a_shared_no_op(monkeypatch):
    """With no profiler recording, a span makes no record, dispatches no
    ``record_function`` and is one shared context; with ``times`` it only
    adds its seconds."""
    called = []
    monkeypatch.setattr(prof_mod, "record_function",
                        lambda name: called.append(name))
    before = spans()
    assert span("a") is span("b")
    with span("a"):
        with span("a.b"):
            torch.ones(4).sum()
    times = {}
    with span("c", times, "c_s"):
        time.sleep(0.002)
    assert called == [] and _new(before) == []
    assert set(times) == {"c_s"} and times["c_s"] >= 0.002


def test_off_leaves_the_profiler_nothing():
    """Spans entered before a session records leave no event in it."""
    with span("before"):
        with _cpu_profile() as p:
            torch.ones(4).sum()
    assert "before" not in {e.name for e in p.events()}


def test_on_records_beside_the_profilers_event():
    with _cpu_profile():   # a process's first record_function is slow
        with span("warm"):
            pass
    before = spans()
    with _cpu_profile() as p:
        with span("t.outer"):
            torch.ones(8).sum()
            with span("t.inner"):
                torch.ones(8).sum()
    recs = {r.name: r for r in _new(before)}
    assert set(recs) == {"t.outer", "t.inner"}
    outer, inner = recs["t.outer"], recs["t.inner"]
    assert outer.parent is None and outer.trace == outer.id
    assert inner.parent == outer.id and inner.trace == outer.id
    assert outer.thread == inner.thread == threading.get_native_id()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    events = {e.name: e for e in p.events()
              if e.name in ("t.outer", "t.inner")}
    assert set(events) == {"t.outer", "t.inner"}
    results = p.profiler.kineto_results
    start = getattr(results, "trace_start_ns", None)
    for name, r in recs.items():
        e = events[name]
        if start is not None:   # the events' µs from the trace's start
            # the record lies inside its event: a stall between the two
            # clock reads of one end widens that side alone, an offset
            # between the clocks takes one side below 0
            sides = (r.start_ns - (start() + e.time_range.start * 1e3),
                     start() + e.time_range.end * 1e3 - r.end_ns)
            assert -2e6 < min(sides) < 2e6, (name, sides)
        else:
            assert abs((r.end_ns - r.start_ns) / 1e3
                       - (e.time_range.end - e.time_range.start)) < 2e3


def test_records_are_bounded_and_counted(monkeypatch):
    monkeypatch.setattr(prof_mod, "SPAN_LIMIT", 3)
    from collections import deque
    monkeypatch.setattr(prof_mod, "_span_records", deque(maxlen=3))
    monkeypatch.setattr(prof_mod, "_span_dropped", 0)
    with _cpu_profile():
        for i in range(5):
            with span(f"b{i}"):
                pass
    assert [r.name for r in spans()] == ["b2", "b3", "b4"]
    assert prof_mod.spans_dropped() == 2


# ----- the restore -----

def _state():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen),
              "layers": {"a": torch.randn(2, 16, 8, generator=gen)}}
    opt = adamw_init(params)
    opt["mu"]["w"] += 1
    return params, opt


@pytest.fixture
def saved(tmp_path):
    ck = Checkpointer(HdfsCluster(tmp_path / "hdfs", throttle=None))
    params, opt = _state()
    ck.save(7, params, opt)
    return ck, params, opt


TIMINGS = {"wave0_bytes", "wave0_alloc_s", "wave0_read_s", "tail_s",
           "tail_bytes"}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("async_tail", [False, True])
def test_restore_timings_keep_their_keys(saved, traced, async_tail):
    """``timings`` holds the same keys, each a duration or a count, with a
    profiler recording or not (``wave0_copy_s`` is the card's alone)."""
    ck, params, opt = saved
    with (_cpu_profile() if traced else span("off")):
        out = ck.restore_planned(7, params, opt, async_tail=async_tail)
        if async_tail:
            out = (out[0],) + out[1].result()
    assert set(ck.timings) == TIMINGS
    assert ck.timings["wave0_read_s"] > 0 and ck.timings["tail_s"] > 0
    assert ck.timings["wave0_alloc_s"] >= 0
    assert ck.timings["wave0_bytes"] == params["w"].nbytes + \
        params["layers"]["a"].nbytes
    assert torch.equal(out[1]["mu"]["w"], opt["mu"]["w"])


def test_async_tail_keeps_the_restarts_trace(saved):
    """The tail runs on the pool's thread, its ``ckpt.tail`` and the reads
    inside it in the trace of the span that asked for the restore."""
    ck, params, opt = saved
    before = spans()
    with _cpu_profile():
        with span("restart"):
            first, tail = ck.restore_planned(7, params, opt,
                                             async_tail=True)
            tail.result()
    recs = _new(before)
    root = next(r for r in recs if r.name == "restart")
    ours = {r.id: r for r in recs if r.trace == root.id}
    assert len(ours) == len(recs)
    (ckpt_tail,) = [r for r in recs if r.name == "ckpt.tail"]
    main = threading.get_native_id()
    assert ckpt_tail.parent == root.id and ckpt_tail.thread != main
    tail_reads = [r for r in recs if r.name == "ckpt.read"
                  and r.thread == ckpt_tail.thread]
    assert tail_reads and all(r.parent == ckpt_tail.id for r in tail_reads)
    wave0 = [r for r in recs if r.name in ("ckpt.alloc", "ckpt.read")
             and r.thread == main]
    assert {r.name for r in wave0} == {"ckpt.alloc", "ckpt.read"}
    assert all(r.parent == root.id for r in wave0)


# ----- the step and the MoE block -----

def test_moe_scopes_keep_their_names():
    assert not hasattr(moe, "record_function")
    cfg = MoEConfig(num_experts=4, experts_per_token=2)
    gen = torch.Generator().manual_seed(1)
    d, f = 8, 16
    args = [torch.randn(*shape, generator=gen)
            for shape in ((6, d), (d, 4), (4, d, f), (4, d, f), (4, f, d))]
    names = {"moe.router", "moe.dispatch", "moe.experts", "moe.combine"}
    before = spans()
    with _cpu_profile() as p:
        moe.moe_block(*args, moe=cfg)
    assert names <= {e.name for e in p.events()}
    assert {r.name for r in _new(before)} == names


def test_step_phases_nest_in_the_step():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    model = Model(reduced(get_config("mamba2-370m")), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig())
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 16))
    batch = {"tokens": tokens, "labels": tokens}
    before = spans()
    with _cpu_profile():
        step(state.params, state.opt, batch)
    recs = _new(before)
    (root,) = [r for r in recs if r.name == "step"]
    phases = {r.name: r for r in recs if r.parent == root.id}
    assert set(phases) == {"step.prepare", "step.forward", "step.backward",
                           "step.optimizer"}
    assert all(r.trace == root.id for r in recs)
    order = sorted(phases.values(), key=lambda r: r.start_ns)
    assert [r.name for r in order] == ["step.prepare", "step.forward",
                                       "step.backward", "step.optimizer"]
