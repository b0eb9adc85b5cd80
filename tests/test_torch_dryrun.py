"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
records against the JAX package's schema (``tests/test_dryrun.py``'s
assertions, on one card: ``collectives`` is ``{"total": 0}``), its pairs
against the reference's, the production meshes running (ROADMAP A.7),
the launch-profile check, and the live-storage tracking its peak
memory comes from (``roofline/step_cost.StepCount``).

The full-size sweep of all 33 pairs runs with ``--all`` (about two
minutes here); one full-size pair runs in the tests.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.ssd import ssd_bwd_workspace_floats
from repro_torch.launch import dryrun
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.roofline.analysis import RooflineReport
from repro_torch.roofline.step_cost import ALLOC_UNIT, StepCount
from repro_torch.tune.launchprofile import capture_launch_profile

REPO = Path(__file__).parent.parent
# the reference's record keys that XLA alone fills
XLA_ONLY = ("cost_xla_raw", "loop_correction_factor", "compile_s", "lower_s")


def _check_record(r: dict, *, tiny: bool) -> None:
    """tests/test_dryrun.py's assertions on one record, on one card."""
    assert r["mesh"] == "1" and r["chips"] == 1 and r["tiny"] is tiny
    assert r["cost"]["flops"] > 0
    assert r["memory"]["peak_memory_in_bytes"] > 0
    assert 0 < r["memory"]["argument_size_in_bytes"] <= \
        r["memory"]["peak_memory_in_bytes"]
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    assert r["collectives"] == {"total": 0}
    for key in ("arch", "shape", "step_kind", "tag", "cost",
                "cost_analytic_global", "trace_s"):
        assert key in r
    assert not any(key in r for key in XLA_ONLY)
    assert r["cost"]["bytes accessed"] == r["cost_analytic_global"]["bytes"]
    rep = RooflineReport(**r["roofline"])
    assert rep.mesh == "1" and rep.memory_per_device_bytes == \
        r["memory"]["peak_memory_in_bytes"]


def test_tiny_dryrun_cli(tmp_path):
    """The reference test's command on one card: a record of the
    reference's schema, and the table."""
    out = tmp_path / "dr.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mixtral-8x22b", "--shape", "train_4k", "--tiny", "--tag", "t",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    _check_record(rec, tiny=True)
    assert (rec["arch"], rec["shape"], rec["step_kind"], rec["tag"]) == (
        "mixtral-8x22b", "train_4k", "train", "t")
    assert "1 ok, 0 failed" in res.stdout and "compute_s" in res.stdout


def test_full_size_pair(tmp_path, capsys):
    """One full-size pair: mamba2-370m decoding one token of 128 sequences
    against their 32,768-long state (it fits one card); its storages are
    the fp32 SSM and conv states, the weights and the fp32 unembedding."""
    out = tmp_path / "dr.jsonl"
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--out",
                 str(out)])
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    _check_record(rec, tiny=False)
    assert rec["step_kind"] == "decode"
    cfg = get_config("mamba2-370m")
    m = Model(cfg, device="meta")
    caches = sum(t.numel() * t.element_size()
                 for t in m.init_cache(128, 32768).values())
    params = sum(t.numel() * t.element_size()
                 for t in tree_leaves(m.init_like()))
    unembed = 4 * cfg.d_model * cfg.vocab_size
    assert rec["memory"]["argument_size_in_bytes"] >= caches + params + \
        unembed
    assert rec["memory"]["peak_memory_in_bytes"] < dryrun.CARD_BYTES
    assert "fits 80 GB" in capsys.readouterr().out


def _reference_long_ok() -> set:
    """``LONG_OK`` of the JAX package's dry run, read from its source (the
    module sets XLA_FLAGS when imported)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "LONG_OK":
            return ast.literal_eval(node.value)
    raise AssertionError("no LONG_OK")


def test_pairs_are_the_references():
    assert dryrun.LONG_OK == _reference_long_ok()
    want = [(a, s) for a in JARCHS for s in JSHAPES
            if s != "long_500k" or a in dryrun.LONG_OK]
    assert list(dryrun.combos()) == want and len(want) == 33


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_production_meshes_are_refused(flag, capsys):
    """Refused until the port sharded (A.7); now each production mesh runs
    the pair in a process of its own over a fake group, one line each
    (tests/test_torch_sharding_dryrun.py checks the records)."""
    dryrun.main([flag, "--arch", "mamba2-370m", "--shape", "decode_32k",
                 "--tiny"])
    out = capsys.readouterr().out
    meshes = ["16x16", "2x16x16"] if flag == "--both-meshes" else \
        ["2x16x16"]
    assert f"{len(meshes)} ok, 0 failed" in out
    for mesh in meshes:
        assert f" {mesh} " in out


def test_launch_profile_drift(tmp_path, monkeypatch, capsys):
    """Drift against a recorded launch profile prints, and under
    ``--strict-launch-profile`` exits 2 before any dry run; an env-cache
    meta embedding the profile is read too."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    path = tmp_path / "lp.json"
    path.write_text(json.dumps(capture_launch_profile().to_json()))
    assert dryrun.check_launch_profile(str(path)) == []
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"launch_profile":
                                capture_launch_profile().to_json()}))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    for p in (path, meta):
        (line,) = dryrun.check_launch_profile(str(p))
        assert "CUBLAS_WORKSPACE_CONFIG" in line
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--tiny",
                     "--launch-profile", str(path),
                     "--strict-launch-profile"])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert "[launch-profile] drift" in out and "[dryrun]" not in out


# ------------------------------------------------- live storages ---

def test_step_count_tracks_live_storages():
    """Arguments alive from the start, each new storage until it is
    freed, views free, sizes rounded to the allocation unit."""
    x = torch.empty((1000, 1000), device="meta")

    def step(x):
        y = x * 2
        del y
        z = x @ x
        w = z[:10]
        return z.sum() + w.sum()

    with StepCount((x,)) as count:
        step(x)
    mib4 = 4_000_000 + (-4_000_000 % ALLOC_UNIT)
    # at the last add: x, z, the two sums and their total; y was freed
    assert count.memory() == {"argument_size_in_bytes": mib4,
                              "peak_memory_in_bytes": 2 * mib4 + 3 * 512}
    cost = count.cost()
    assert cost["flops"] == cost["flops_fp32"] == 2 * 1000 ** 3
    assert cost["by_op"]["aten.mm"]["bytes"] == 3 * 4_000_000


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_decode_peak_on_meta_is_the_cpus(arch):
    """A decode step runs no kernel, so the same step on CPU tensors makes
    the same storages: the meta peak is the CPU's, byte for byte."""
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("d", 96, 3, "decode")
    rec = dryrun.run_one(arch, cfg=cfg, shape=shape, verbose=False)
    fn, args, _ = dryrun.build_step(Model(cfg, device="cpu"), shape)
    args = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype)
                    if t.device.type == "meta" else t, args)
    with StepCount(args) as count:
        fn(*args)
    assert count.memory() == rec["memory"]
    assert count.cost()["flops"] == rec["cost"]["flops"]


def test_ssd_backward_workspace_is_counted():
    """A training step's SSD backward takes its workspace as an argument,
    so the count sees it: in the operator's bytes and the peak."""
    cfg = reduced(get_config("mamba2-370m"))
    shape = ShapeConfig("t", 64, 2, "train")
    rec = dryrun.run_one("mamba2-370m", cfg=cfg, shape=shape, verbose=False)
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    ws = 4 * ssd_bwd_workspace_floats(2, 64, h, s.head_dim, s.state_dim)
    op = rec["cost_analytic_global"]["by_op"]["repro_torch.ssd_bwd"]
    assert op["calls"] == cfg.num_layers and op["bytes"] > cfg.num_layers * ws
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] + ws


def _reference_record_keys() -> tuple[set, dict]:
    """The keys of the reference's ``run_one`` record (its ``out`` dict)
    and its argparse flags' defaults, read from its source (the module sets
    XLA_FLAGS when imported)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    keys, flags = set(), {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "out" and \
                isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default", kw.get("action"))
            flags[node.args[0].value] = (
                default.value if isinstance(default, ast.Constant) else None)
    return keys, flags


def test_ssd_knobs_and_no_remat_are_recorded_as_the_reference(tmp_path):
    """``--ssd-compute-dtype bfloat16 --ssm-chunk 64 --no-remat`` on a tiny
    pair: the flags are the reference's (names, defaults), and the record
    holds ``ssd_compute_dtype``, ``ssm_chunk`` and ``remat`` as the
    reference's record names them, with the flags' values."""
    keys, flags = _reference_record_keys()
    fields = ("ssd_compute_dtype", "ssm_chunk", "remat")
    assert set(fields) <= keys
    assert {f: flags[f] for f in ("--ssd-compute-dtype", "--ssm-chunk",
                                  "--no-remat")} == {
        "--ssd-compute-dtype": "float32", "--ssm-chunk": 0,
        "--no-remat": "store_true"}
    out = tmp_path / "dr.jsonl"
    dryrun.main(["--arch", "mamba2-370m", "--shape", "train_4k", "--tiny",
                 "--ssd-compute-dtype", "bfloat16", "--ssm-chunk", "64",
                 "--no-remat", "--out", str(out)])
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    _check_record(rec, tiny=True)
    assert {f: rec[f] for f in fields} == {
        "ssd_compute_dtype": "bfloat16", "ssm_chunk": 64, "remat": False}
    dryrun.main(["--arch", "mamba2-370m", "--shape", "train_4k", "--tiny",
                 "--out", str(out)])
    default = json.loads(out.read_text().splitlines()[-1])
    assert {f: default[f] for f in fields} == {
        "ssd_compute_dtype": "float32", "ssm_chunk": 0, "remat": True}
    # the mesh workers are handed the same flags
    assert dryrun.knob_args(dict(ssd_compute_dtype="bfloat16", ssm_chunk=64,
                                 remat=False)) == [
        "--ssd-compute-dtype", "bfloat16", "--ssm-chunk", "64", "--no-remat"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2.5-3b"])
def test_no_remat_raises_a_train_pairs_peak(arch):
    """Without remat every layer's activations stay for the backward: a
    tiny training pair's counted peak rises; the FLOPs fall by the
    recompute. The SSD knobs leave a step's FLOPs and bytes as they are
    (the operators price both instances alike)."""
    recs = {name: dryrun.run_one(arch, "train_4k", tiny=True, knobs=knobs,
                                 verbose=False)
            for name, knobs in (("remat", {}), ("none", {"remat": False}),
                                ("bf16", {"ssd_compute_dtype": "bfloat16"}))}
    peak = {k: r["memory"]["peak_memory_in_bytes"] for k, r in recs.items()}
    assert recs["none"]["remat"] is False and recs["remat"]["remat"] is True
    assert peak["none"] > peak["remat"]
    assert recs["none"]["cost"]["flops"] < recs["remat"]["cost"]["flops"]
    assert recs["bf16"]["cost"] == recs["remat"]["cost"]
