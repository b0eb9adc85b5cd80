"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
found from data: each cell's configuration, traffic and limits file, each
metric's reader. A cell, a configuration and a per-layer metric are added
by new files and entries alone (run in a copy of ``perfbench/``)."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_name_is_found_from_data():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        pb = ROOT / "perfbench"
        assert (pb / "configs" / f"{w['config']}.json").is_file()
        traffic = json.loads((pb / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (pb / "kinds" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((pb / "limits" /
                             f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v is None or math.isfinite(v)
                              for v in limits.values())
        reported = [m for m in BENCH["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    assert used == configs
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        mover = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", cells))


ADDED_READER = '''
def read(run):
    return float(run.window["attempted"])
'''

TRACED_READER = '''
def read(run):
    return run.trace.units if run.trace is not None else None
'''

ADDED = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from perfbench import harness
assert harness.ROOT == __import__("pathlib").Path(sys.argv[1])
tiny = dict(num_layers=2, d_model=64, vocab_size=256,
            ssm=dict(state_dim=16, head_dim=16, expand=2, conv_width=4,
                     chunk_size=32, ngroups=1))
for trace in (False, True):
    r = harness.run_cell("tiny-mamba.train-b2s64", 7, 0.2, trace,
                         device="cpu", cfg_override=tiny)
    print(json.dumps(r))
print(json.dumps(getattr(sys.modules["perfbench.reference.ssm"], "CALLS",
                         None)))
"""

# the test's own reference module: the real one, loaded from its file, with
# the three names the harness resolves counted as they are called
OWN_REFERENCE = """
import collections
import importlib.util

_spec = importlib.util.spec_from_file_location("real_ssm", {real!r})
real = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(real)
globals().update({{k: v for k, v in vars(real).items()
                  if not k.startswith("__")}})
CALLS = collections.Counter()


def _counted(fn):
    def counted(*args, **kw):
        CALLS[fn.__name__] += 1
        return fn(*args, **kw)
    return counted


Reference = _counted(real.Reference)
schema = _counted(real.schema)
step_flops = _counted(real.step_flops)
"""


@pytest.mark.parametrize("own_reference", [False, True])
def test_a_cell_config_and_metric_added_by_files_alone(tmp_path,
                                                       own_reference):
    """A copy of perfbench/ gains a configuration, a traffic mix, a cell's
    limits, an end-to-end and a per-layer metric's readers, and
    BENCHMARK.json their entries; no file of the copy is edited, and the
    new cell runs and reports them. With ``own_reference`` the copy's
    reference module of the architecture is the test's own (the real one
    re-exported), and the cell runs to ``correct`` through it: its model,
    schema and step FLOPs."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    if own_reference:
        (pb / "reference" / "ssm.py").write_text(OWN_REFERENCE.format(
            real=str(ROOT / "perfbench" / "reference" / "ssm.py")))
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "mamba2-370m.json").read_text())
    cfg["name"] = "tiny-mamba"
    (pb / "configs" / "tiny-mamba.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "train-b16s2048.json")
                         .read_text())
    traffic.update(batch=2, seq_len=64, reference_rows=1)
    (pb / "traffic" / "train-b2s64.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny-mamba.train-b2s64.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}}))
    (pb / "metrics" / "steps_done.py").write_text(ADDED_READER)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-mamba", "source": "test",
                             "file": "perfbench/configs/tiny-mamba.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-mamba.train-b2s64",
                               "config": "tiny-mamba",
                               "traffic": "train-b2s64", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-mamba.train-b2s64")
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny-mamba.train-b2s64"]})
    if own_reference:
        for m in bench["per_layer"]:
            if m["name"] == "step_mfu.train":
                m["workloads"].append("tiny-mamba.train-b2s64")
    bench["per_layer"].append({"name": "steps_traced.test", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "step", "moves": "steps_done",
                               "workloads": ["tiny-mamba.train-b2s64"]})
    (pb / "metrics" / "steps_traced.test.py").write_text(TRACED_READER)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", ADDED, str(tmp_path), str(ROOT / "src")],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced, calls = (json.loads(x)
                            for x in out.stdout.strip().splitlines())
    assert plain["metrics"]["steps_done"]["value"] >= 1
    assert set(plain["metrics"]) == {"steps_done", "setup_s",
                                     "train_tokens_per_s"}
    assert traced["metrics"]["steps_traced.test"]["value"] == 3
    if own_reference:
        assert plain["correct"] and traced["correct"]
        assert traced["metrics"]["step_mfu.train"]["value"] > 0
        assert set(calls) == {"Reference", "schema", "step_flops"}
    else:
        assert "step_mfu.train" not in traced["metrics"]
        assert calls is None
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_program_config_takes_groups_and_tuples():
    """A configuration's groups become the dataclasses of the program's
    fields, and a list a tuple where the field is one."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    from repro_torch.configs.base import MoEConfig, SSMConfig
    cfg = harness.program_config(dict(
        name="t", arch_type="moe", source="test", mrope_sections=[8, 12, 12],
        moe=dict(num_experts=4, experts_per_token=2, capacity_factor=8.0),
        ssm=dict(state_dim=16), frontend="none"))
    assert cfg.moe == MoEConfig(4, 2, capacity_factor=8.0)
    assert cfg.ssm == SSMConfig(state_dim=16)
    assert cfg.mrope_sections == (8, 12, 12)
    assert cfg.frontend == "none"


@pytest.mark.parametrize("cfg", [c["file"] for c in BENCH["configs"]])
def test_configuration_is_the_programs(cfg):
    """Each configuration file builds the program's config of the same
    name (the citation aside), with the same parameter count."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import dataclasses
    from perfbench import generator, harness
    from repro_torch.configs import get_config
    data = json.loads((ROOT / cfg).read_text())
    mine = harness.program_config(data)
    theirs = get_config(data["name"])
    assert dataclasses.replace(mine, source=theirs.source) == theirs
    total = sum(math.prod(s) for s, _ in generator.schema(data).values())
    assert total == data["parameters"]
