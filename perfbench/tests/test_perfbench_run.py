"""Whole runs on the CPU at a shrunken size (the program's plain kernels):
the result's last line as the contract has it; the look for a card; the
faults that a cell can have, planted under the timed path, each turning
``correct`` false; and the modules a run and the reference load."""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

SSM = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=32,
           ngroups=1)
MAMBA = dict(num_layers=2, d_model=64, vocab_size=256, ssm=SSM)
TRAFFIC = dict(batch=2, seq_len=64, reference_rows=1, trace_steps=2)
CELLS = {"mamba2-370m.train-b16s2048": MAMBA,
         "mamba2-370m.resume-b16s2048": MAMBA}
SEED = 2 ** 31 + 12345


def run(cell, trace=False, seed=SEED, limits=None):
    return harness.run_cell(cell, seed, 0.3, trace, device="cpu",
                            cfg_override=CELLS[cell],
                            traffic_override=TRAFFIC, limits=limits)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_last_line(cell, trace):
    result = run(cell, trace)
    out, err = io.StringIO(), io.StringIO()
    harness.report(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    bench = harness.spec()
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in harness.metrics_for(bench, cell, kind)}
    assert set(line["metrics"]) <= listed
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert {"setup_s"} < set(line["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(line["check"])
    assert names == set(harness.load_json("limits", f"{cell}.json")
                        ["limits"])
    last = err.getvalue().strip().splitlines()
    assert last[-1] == f"check correct {line['correct']}"
    assert len(last) == len(names) + 1


def test_same_seed_same_inputs_and_readings():
    cell = "mamba2-370m.train-b16s2048"
    a, b = run(cell), run(cell)
    assert a["check"] == b["check"]
    assert run(cell, seed=SEED + 1)["check"] != a["check"]


@pytest.mark.parametrize("module", ["jax", "repro.models"])
def test_barred_module_loaded_by_the_comparison_gives_no_result(
        module, monkeypatch):
    """A barred module that the reference's comparison loads, after the
    window has closed, still leaves the run without a result."""
    import types
    from perfbench.kinds import train
    real = train.Job.reference

    def reference(self, *a, **k):
        monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
        return real(self, *a, **k)

    monkeypatch.setattr(train.Job, "reference", reference)
    with pytest.raises(harness.RunError, match=module.split(".")[0]):
        run("mamba2-370m.train-b16s2048")


def test_no_card_no_result():
    """On a machine without CUDA the command prints no result and exits
    with another code than 0."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-370m.train-b16s2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout == ""


# ----- faults planted under the timed path -----

def _unchanged(real):
    """A step that returns its state unchanged (its loss still computed)."""
    def make(model, opt_cfg, *a, **k):
        step = real(model, opt_cfg, *a, **k)

        def fn(params, opt, batch):
            from repro_torch.optim.adamw import tree_map
            copy = lambda t: tree_map(torch.clone, t)  # noqa: E731
            _, _, m = step(copy(params), copy(opt), batch)
            return params, opt, m
        return fn
    return make


def _half_batch(real):
    """Half of the batch left out, the mean taken over the rest."""
    def make(model, opt_cfg, *a, **k):
        step = real(model, opt_cfg, *a, **k)

        def fn(params, opt, batch):
            half = {n: t[: t.shape[0] // 2] for n, t in batch.items()}
            return step(params, opt, half)
        return fn
    return make


def _loss_altered(real):
    """The step's reported loss altered where it is produced."""
    def make(model, opt_cfg, *a, **k):
        step = real(model, opt_cfg, *a, **k)

        def fn(params, opt, batch):
            params, opt, m = step(params, opt, batch)
            return params, opt, dict(m, loss=m["loss"] * 1.01)
        return fn
    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _loss_altered])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    import repro_torch.train.loop as loop
    import repro_torch.train.step as step
    limits = harness.load_json("limits", f"{cell}.json")["limits"]
    assert run(cell, limits=limits)["correct"]
    broken = fault(step.make_train_step)
    for mod in (step, loop):
        monkeypatch.setattr(mod, "make_train_step", broken)
    assert not run(cell, limits=limits)["correct"]


def _control(cell, seed, device, cfg_override=None, traffic_override=None):
    """The control's numbers: the reference with every matrix product's
    operands in scaled float8, put in the program's place."""
    from perfbench import check
    from perfbench.reference.common import Precision
    bench = harness.spec()
    w = harness.cell_of(bench, cell)
    cfg = dict(harness.load_json("configs", f"{w['config']}.json"),
               **(cfg_override or {}))
    traffic = dict(harness.load_json("traffic", f"{w['traffic']}.json"),
                   **(traffic_override or {}))
    kind = harness.kind_module(traffic["kind"])
    job = kind.Job(harness.Run(w, cfg, traffic, seed), device=device)
    try:
        return check.numbers(job.reference(prec=Precision("fp8")),
                             job.reference())
    finally:
        job.close()


@pytest.mark.parametrize("cell", ["mamba2-370m.train-b16s2048"])
def test_control_reads_above_the_program(cell):
    """At the CPU's size the control's gradient departs from the reference
    further than the program's does (at the cells' own sizes it fails
    their limits: the card test below)."""
    sound = run(cell)["check"]
    control = _control(cell, SEED, "cpu", CELLS[cell], TRAFFIC)
    assert control["grad_gap"] > 2 * sound["grad_gap"]["value"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct_on_the_card(cell, card):
    """The control at the cell's own size, on three seeds, fails one of
    the cell's numbers on each."""
    from perfbench import check
    limits = harness.load_json("limits", f"{cell}.json")["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        nums = _control(cell, seed, card)
        assert not check.verdict(nums, limits)[0], (seed, nums)


IMPORTS = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from perfbench import harness
for m in ("reference.common", "reference.ssm", "reference.train"):
    __import__("perfbench." + m)
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(tops & {"repro_torch", "repro", "jax", "jaxlib",
                                "flax"})))
r = harness.run_cell("mamba2-370m.train-b16s2048", 5, 0.2, True,
                     device="cpu", cfg_override=json.loads(sys.argv[2]),
                     traffic_override=json.loads(sys.argv[3]))
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(tops & {"repro_torch", "repro", "jax", "jaxlib",
                                "flax"})))
"""


def test_modules_loaded():
    """The reference loads nothing of the program; a whole run (its
    reference included) loads neither JAX nor the JAX package, compared by
    top-level names."""
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS, str(ROOT), json.dumps(MAMBA),
         json.dumps(TRAFFIC)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    before, after = (json.loads(x) for x in out.stdout.split("\n")[:2])
    assert before == []
    assert after == ["repro_torch"]


def test_reference_sources_name_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        for word in ("import repro", "from repro", "jax"):
            assert word not in text, (path, word)
