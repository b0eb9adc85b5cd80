"""The yardstick's frozen formulas against hand counts at small shapes, the
model-FLOPs arithmetic, and the trace reading on a made-up timeline."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import generator, yardstick  # noqa: E402
from perfbench.harness import RunError  # noqa: E402
from perfbench.reference import architecture  # noqa: E402


def test_ssd_costs_by_hand():
    # B 1, S 4, H 1, P 2, G 1, N 3 at chunk 2: 2 chunks of 3 (i >= j) pairs
    assert yardstick.ssd_fwd_flops(1, 4, 1, 2, 1, 3, 2) == \
        2 * 3 * 2 * 3 + 2 * 3 * 2 * 2 + 4 * 4 * 3 * 2
    assert yardstick.ssd_bwd_flops(1, 4, 1, 2, 1, 3, 2) == \
        2 * 3 * 2 * 3 + 2 * 3 * (4 * 2 + 4 * 3) + 4 * 10 * 3 * 2
    flops, nbytes = yardstick.ssd_fwd_cost(1, 4, 1, 2, 1, 3)
    assert flops == min(yardstick.ssd_fwd_flops(1, 4, 1, 2, 1, 3, t)
                        for t in yardstick.SSD_TILES)
    assert nbytes == 2 * 2 * 4 * 2 + 4 * 4 + 2 * 2 * 4 * 3 + 4 * 2 * 3
    assert yardstick.least_seconds(989e12, 1.0) == 1.0
    assert yardstick.least_seconds(1.0, 3.35e12) == 1.0


TINY = dict(arch_type="ssm", num_layers=3, d_model=8, vocab_size=10,
            ssm=dict(state_dim=2, head_dim=4, expand=2, conv_width=4,
                     chunk_size=4, ngroups=1))


def test_parameter_count_by_hand():
    d, di, h, gn, w, v = 8, 16, 4, 2, 4, 10
    mamba = (d + 2 * d * di + 2 * d * gn + d * h + w * di + di
             + 2 * (w * gn + gn) + 3 * h + di + di * d)
    assert generator.count_params(TINY) == d + d * v + 3 * mamba


def test_step_flops_by_hand():
    b, s = 2, 4
    n = generator.count_params(TINY)
    ssd = 3 * (yardstick.ssd_fwd_cost(b, s, 4, 4, 1, 2)[0]
               + yardstick.ssd_bwd_cost(b, s, 4, 4, 1, 2)[0])
    assert architecture(TINY).step_flops(TINY, b, s) == ssd
    assert yardstick.step_model_flops(TINY, b, s, n) == 6 * n * b * s + ssd


def test_an_architecture_without_a_schema_is_refused():
    """Schema, weights and step FLOPs of an arch_type with no reference
    module are refused, naming the file looked for."""
    cfg = dict(TINY, arch_type="unmodelled")
    looked_for = "perfbench/reference/unmodelled.py"
    for fn in (lambda: generator.schema(cfg),
               lambda: generator.weights(cfg, 1, "cpu"),
               lambda: yardstick.step_model_flops(cfg, 2, 4, 1)):
        with pytest.raises(RunError, match=looked_for):
            fn()


def ev(name, start, end, device=False, shapes=(), inside=0.0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=SimpleNamespace(name="CUDA" if device else "CPU"),
        input_shapes=list(shapes), device_time_total=inside)


def test_trace_reading_on_a_made_up_timeline():
    """Two steps: the host spans, three kernels (two overlapping) and a
    copy; times in microseconds as the profiler gives them."""
    events = [
        ev("bench.step", 0, 1000), ev("bench.step", 1000, 2000),
        ev("repro_torch::ssd_fwd", 10, 50, shapes=[[1, 4, 1, 2], [], [],
                                                   [1, 4, 1, 3]], inside=300),
        ev("aten::item", 600, 900),
        ev("k1", 100, 400, device=True), ev("k2", 300, 500, device=True),
        ev("Memcpy HtoD", 1100, 1200, device=True),
        ev("k1", 1300, 1400, device=True),
    ]
    tr = yardstick.Trace(events, window_s=2e-3, units=2)
    assert tr.busy_s == pytest.approx((400 + 100 + 100) / 1e6)
    assert tr.kernels_s == pytest.approx((300 + 200 + 100) / 1e6)
    assert tr.op_seconds(yardstick.OPS) == pytest.approx(300e-6)
    assert tr.calls("repro_torch::ssd_fwd") == [[[1, 4, 1, 2], [], [],
                                                 [1, 4, 1, 3]]]
    # the gap 500-1100 lies in the first step, its midpoint in aten::item
    assert tr.gaps["bench.step / aten::item"] == pytest.approx(600e-6)
    assert tr.gaps["bench.step / python"] == pytest.approx(100e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(400e-6)]
    assert len(b["idle_gaps"]) == 2
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(700e-6)
