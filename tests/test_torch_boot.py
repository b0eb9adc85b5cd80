"""The port's BootSeer startup half against the JAX package's, on the CPU
at small sizes: container images and hot-block records, the env cache,
stage logs, the runtime end to end (the scenarios of
tests/test_bootseer_e2e.py, with the port's ``Checkpointer`` over a
checkpoint the JAX one wrote), launch profiles, both launchers booting
twice on one workdir, the card-only environment (the kernel library) with
``build.build`` replaced, and the two witnesses: lock order and I/O slots.

Each comparison runs both packages on the same inputs, made from seeded
numpy bytes. The runtime scenarios throttle the DFS so that one task chain
gates each run by a wide margin: critical paths and gating counts are
then a property of the inputs, not of the host's timing.
"""

import importlib
import json
import os
import stat
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch_io_witness

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.dfs.hdfs import HdfsCluster as JHdfs
from repro_torch.blockstore.registry import Registry
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.bootseer import BootseerRuntime, JobSpec
from repro_torch.core.pipeline import CRITICAL
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.kernels import build
from repro_torch.launch import boot
from repro_torch.tune.launchprofile import (TRACKED_ENV_VARS,
                                            capture_launch_profile,
                                            profile_drift)

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
DIRECTIONS = [("repro", "repro_torch"), ("repro_torch", "repro")]
BS = 64 * 1024
# a fixed mtime for the stand-in install's files: the env archive's tar
# headers, and so its compressed size, are then the same in both runs
MTIME_NS = 1_700_000_000 * 10**9


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def ids(direction):
    return "->".join("jax" if p == "repro" else "port" for p in direction)


def _source_tree(root: Path, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    src = root / "src"
    (src / "bin").mkdir(parents=True)
    (src / "lib" / "deep").mkdir(parents=True)
    for rel, blocks in (("bin/start", 6), ("weights.ref", 20),
                        ("lib/deep/part.so", 3)):
        (src / rel).write_bytes(
            rng.integers(0, 256, blocks * BS + 17, dtype=np.uint8).tobytes())
    (src / "empty").write_bytes(b"")
    return src


def _files(root: Path) -> dict:
    """{relpath: (bytes, mode bits)} of every file under ``root``."""
    return {str(p.relative_to(root)): (p.read_bytes(),
                                       stat.S_IMODE(p.stat().st_mode))
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------------- images ---

def test_same_tree_gives_the_same_image(tmp_path):
    src = _source_tree(tmp_path)
    mans = [mod(p, "blockstore.image").build_image(
        src, mod(p, "blockstore.registry").Registry(tmp_path / p), "img",
        block_size=BS) for p in PKGS]
    assert mans[0].digest == mans[1].digest
    assert mans[0].to_json() == mans[1].to_json()


@pytest.mark.parametrize("direction", DIRECTIONS, ids=ids)
def test_lazy_client_reads_the_other_packages_image(tmp_path, direction):
    writer, reader = direction
    src = _source_tree(tmp_path)
    mod(writer, "blockstore.image").build_image(
        src, mod(writer, "blockstore.registry").Registry(tmp_path / "reg"),
        "img", block_size=BS)
    reg = mod(reader, "blockstore.registry").Registry(tmp_path / "reg")
    client = mod(reader, "blockstore.lazy").LazyImageClient(
        reg.get_manifest("img"), reg, tmp_path / "cache")
    for rel, (data, _) in _files(src).items():
        assert client.read_file(rel) == data
        assert client.read_file(rel, 5, 70_000) == data[5:70_005]
    assert client.cached_fraction() == 1.0


@pytest.mark.parametrize("direction", DIRECTIONS, ids=ids)
def test_hot_block_record_crosses_packages(tmp_path, direction):
    """A record written by one package is read, and prefetched, by the
    other: the same hot blocks in the same order."""
    writer, reader = direction
    src = _source_tree(tmp_path)
    reg_w = mod(writer, "blockstore.registry").Registry(tmp_path / "reg")
    man = mod(writer, "blockstore.image").build_image(src, reg_w, "img",
                                                      block_size=BS)
    client = mod(writer, "blockstore.lazy").LazyImageClient(
        man, reg_w, tmp_path / "cache_w")
    client.read_file("bin/start")
    client.read_file("lib/deep/part.so", 0, BS)
    hot_w = mod(writer, "blockstore.prefetch").HotBlockService(tmp_path / "hot")
    hot_w.record(man.digest, client.access_trace())

    pre = mod(reader, "blockstore.prefetch")
    service = pre.HotBlockService(tmp_path / "hot")
    assert service.has_record(man.digest)
    assert service.hot_blocks(man.digest) == hot_w.hot_blocks(man.digest)
    reg_r = mod(reader, "blockstore.registry").Registry(tmp_path / "reg")
    fresh = mod(reader, "blockstore.lazy").LazyImageClient(
        reg_r.get_manifest("img"), reg_r, tmp_path / "cache_r")
    _, cold = pre.prefetch_image(fresh, service, defer_cold=True)
    hot = service.hot_blocks(man.digest)
    assert hot and all(fresh.has_block(h) for h in hot)
    assert reg_r.stats["unique_blocks_served"] == len(set(hot))
    cold()
    assert fresh.cached_fraction() == 1.0


# ---------------------------------------------------------- env cache ---

@pytest.mark.parametrize("params", [
    {"arch": "qwen2.5-3b", "deps": ["framework==2.1"]},
    {"arch": "mamba2-370m", "mode": "serve"},
    {"deps": ["a==1"], "gpu": "H800", "kernels": "0123456789abcdef"},
    {}])
def test_job_cache_key_is_the_references(params):
    keys = {mod(p, "envcache.snapshot").job_cache_key(params) for p in PKGS}
    assert len(keys) == 1


@pytest.mark.parametrize("direction", DIRECTIONS, ids=ids)
def test_env_snapshot_restores_in_the_other_package(tmp_path, direction):
    """A snapshot made by one package restores in the other into the same
    tree: names, bytes and modes, clamped (owner rw kept, setuid and
    setgid dropped). Archives are not compared: tar stores mtimes."""
    writer, reader = direction
    rng = np.random.default_rng(1)
    target = tmp_path / "env"
    modes = {"bin/tool": 0o755, "lib/x/libk.so": 0o644, "priv.cfg": 0o400,
             "suid": 0o4755, "sgid.sh": 0o2750, "kernels/libk.log": 0o640}
    for rel, mode in modes.items():
        (target / rel).parent.mkdir(parents=True, exist_ok=True)
        (target / rel).write_bytes(
            rng.integers(0, 256, int(rng.integers(0, 300_000)),
                         dtype=np.uint8).tobytes())
    (target / "late.py").write_text("x = 1\n")
    for rel, mode in modes.items():
        os.chmod(target / rel, mode)
        os.utime(target / rel, ns=(MTIME_NS, MTIME_NS))
    modes["late.py"] = stat.S_IMODE((target / "late.py").stat().st_mode)

    def cache(pkg):
        mount = mod(pkg, "dfs.fuse").HdfsFuseMount(
            mod(pkg, "dfs.hdfs").HdfsCluster(tmp_path / "hdfs"))
        return mod(pkg, "envcache.snapshot").EnvCache(mount)

    key = mod(writer, "envcache.snapshot").job_cache_key({"a": 1})
    cache(writer).create(key, target, {}, {"a": 1})
    got = {}
    for pkg in (writer, reader):
        out = tmp_path / f"restored_{pkg}"
        meta = cache(pkg).restore(key, out)
        assert meta is not None and meta["files"] == len(modes)
        got[pkg] = _files(out)
    assert got[reader] == got[writer]
    clamp = {rel: (m | 0o600) & 0o777 & ~stat.S_ISUID & ~stat.S_ISGID
             for rel, m in modes.items()}
    assert {rel: m for rel, (_, m) in got[reader].items()} == clamp
    assert {rel: b for rel, (b, _) in got[reader].items()} == {
        rel: (target / rel).read_bytes() for rel in modes}


# --------------------------------------------------------- stage logs ---

@pytest.mark.parametrize("direction", DIRECTIONS, ids=ids)
def test_stage_logs_parse_in_both_analysis_services(direction):
    writer, reader = direction
    prof_w = mod(writer, "core.profiler")
    stages = mod(writer, "core.stages").Stage
    t = iter(np.cumsum(np.random.default_rng(2).uniform(0.01, 2.0, 64)))
    text = ""
    for node in ("node000", "node001"):
        log = prof_w.StageLogger("job#r0", node, clock=lambda: float(next(t)))
        for st in (stages.IMAGE_LOAD, stages.ENV_SETUP, stages.MODEL_INIT):
            log.begin(st)
            log.begin("task:" + st.value)
            log.end("task:" + st.value)
            log.end(st)
        log.begin(stages.TRAINING)
        text += log.lines()
    durations = []
    for pkg in (writer, reader):
        svc = mod(pkg, "core.profiler").StageAnalysisService()
        svc.ingest_log(text)
        assert svc.jobs() == ["job#r0"]
        durations.append((svc.node_stage_durations("job#r0"),
                          svc.task_spans("job#r0"),
                          svc.job_level_overhead("job#r0")))
    assert durations[0] == durations[1]
    assert set(durations[0][0]["node001"]) >= {"image_load", "env_setup",
                                               "model_init"}


# ------------------------------------------------ the runtime end to end ---

def _stand_in_install(target, rank):
    """The e2e tests' "pip install", with fixed mtimes."""
    time.sleep(0.4)
    for i in range(6):
        p = target / f"dep{i}.py"
        p.write_text(f"x={i}")
        os.utime(p, ns=(MTIME_NS, MTIME_NS))


def _inputs(pkg: str, root: Path, *, opt: bool = False,
            throttled: bool = True):
    """The e2e fixture for ``pkg`` under ``root``: the image in a
    throttled registry, and a checkpoint of step 100 (params, with
    ``opt`` also AdamW's moments) the JAX Checkpointer wrote into a DFS
    that ``pkg``'s cluster then reads, ``throttled`` so that a node's
    params wave takes ~0.2 s. Returns (registry, hdfs, checkpointer)."""
    src = _source_tree(root)
    reg = mod(pkg, "blockstore.registry").Registry(
        root / "reg", throttle=mod(pkg, "dfs.hdfs").ThrottleModel(
            bandwidth=5e8, throttle_after=2, timescale=2e-3))
    mod(pkg, "blockstore.image").build_image(src, reg, "img", block_size=BS)
    jck = JCheckpointer(JHdfs(root / "hdfs", num_groups=8,
                              block_size=1 << 20), striped=True, width=8)
    params = {"w": np.arange(64 * 4096, dtype=np.float32).reshape(64, -1)}
    trees = (params, {"mu": {"w": np.ones((1024, 1024), np.float32)},
                      "nu": {"w": np.ones((1024, 1024), np.float32)}}) \
        if opt else (params,)
    jck.save(100, *trees)
    throttle = mod(pkg, "dfs.hdfs").ThrottleModel(
        bandwidth=4e6, per_stream=1e6, timescale=1.0) if throttled else None
    hdfs = mod(pkg, "dfs.hdfs").HdfsCluster(
        root / "hdfs", num_groups=8, block_size=1 << 20, throttle=throttle)
    ck = (JCheckpointer if pkg == "repro" else Checkpointer)(
        hdfs, striped=True, width=8)
    return reg, hdfs, ck


def _spec(pkg: str, n: int = 3, **kw):
    return mod(pkg, "core.bootseer").JobSpec(**{
        "job_id": "trainjob", "image": "img", "num_nodes": n,
        "job_params": {"deps": ["a==1"], "gpu": "H800"},
        "startup_reads": [("bin/start", 0, -1)],
        "env_setup": _stand_in_install, "resume_step": 100,
        "resume_plan": "rows", **kw})


def _runtime(pkg, reg, hdfs, workdir, **kw):
    return mod(pkg, "core.bootseer").BootseerRuntime(
        registry=reg, hdfs=hdfs, workdir=workdir, **kw)


def _summary(res, rt) -> dict:
    """What must be the same in both packages, whichever thread finishes
    first: stage and task names, critical paths (each node's chain ends in
    its gating task, and every task before it is one that task waits on),
    gating counts, whether the hot record was used, and the scheduler's
    bytes after the deferred work drained: the DFS's by priority and the
    registry's deferred bytes. The image's critical bytes are
    ``_image_critical``'s."""
    rt.drain_deferred()
    crit = res.notes["critical_path"]
    snap = rt.io_sched.snapshot() if rt.io_sched is not None else None
    return {
        "prefetch_used": res.notes["prefetch_used"],
        "gating_counts": res.notes["gating_counts"],
        "chains": {node: a["chain"] for node, a in crit.items()},
        "tasks": {node: sorted(a["tasks"]) for node, a in crit.items()},
        "stages": {node: sorted(s) for node, s in res.node_stage_s.items()},
        # a block's "peer" bytes depend on which node's thread won its
        # singleflight, in either package, so they are no property of the
        # inputs
        "io": ({r: ({p: v["bytes"][p] for p in ("critical", "deferred")}
                    if r == "dfs" else {"deferred": v["bytes"]["deferred"]})
                for r, v in snap.items() if r != "peer"}
               if snap is not None else None),
        "image_critical": ({r: snap[r]["bytes"]["critical"]
                            for r in ("registry", "peer") if r in snap}
                           if snap is not None else None)}


def _image_critical(record: dict, *runs: dict) -> None:
    """The image's critical bytes by resource: which node's thread wins a
    block's singleflight decides whether another node takes it from the
    registry or from a peer, in either package (the warm boot's registry
    bytes were one hot set in most runs and two in a few, its peer bytes
    two to four). What the inputs fix: every such count is a whole number
    of the hot set, the record run's registry bytes, and the registry
    serves each node at most once. Takes the counts out of the runs."""
    unit = record["image_critical"]["registry"]
    assert unit > 0
    for run in (record, *runs):
        got = run.pop("image_critical")
        assert all(v % unit == 0 for v in got.values()), got
        assert 1 <= got["registry"] // unit <= len(run["tasks"]), got


def _baseline_record_warm(pkg: str, root: Path) -> list:
    reg, hdfs, ck = _inputs(pkg, root)
    base = _runtime(pkg, reg, hdfs, root / "wb", optimize=False)
    out = [_summary(base.run_startup(_spec(pkg), checkpointer=ck), base)]
    rt = _runtime(pkg, reg, hdfs, root / "wo")
    for _ in range(2):
        out.append(_summary(rt.run_startup(_spec(pkg), checkpointer=ck), rt))
    out.append(dict(rt.env_cache.stats))
    base.close()
    rt.close()
    return out


def test_baseline_record_and_warm_boots_as_the_reference(tmp_path):
    """The reference's baseline-vs-BootSeer scenario on both runtimes: the
    same stages, tasks, critical paths, gating counts, hot-record use and
    scheduler bytes. The baseline is gated by its params wave (its stages
    run one after the other), the record run by the install behind the
    image, the warm run by the throttled params wave."""
    jax_runs = _baseline_record_warm("repro", tmp_path / "jax")
    port_runs = _baseline_record_warm("repro_torch", tmp_path / "port")
    for base, record, warm, _ in (jax_runs, port_runs):
        assert base.pop("image_critical") is None
        _image_critical(record, warm)
    assert port_runs == jax_runs
    base, record, warm, env_stats = port_runs
    assert [r["prefetch_used"] for r in (base, record, warm)] == [
        False, False, True]
    assert record["gating_counts"] == {"env.install": 3}
    assert warm["gating_counts"] == {"ckpt.params_wave": 3}
    assert env_stats == {"dfs_archive_fetches": 1, "local_cache_hits": 2}
    assert warm["io"]["dfs"]["critical"] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_deferred_opt_wave_failure_surfaces(tmp_path, pkg):
    """A stripe file lost between the params wave and the deferred
    optimizer-state wave fails drain_deferred(), in both runtimes."""
    reg, hdfs, ck = _inputs(pkg, tmp_path, opt=True, throttled=False)
    files = hdfs.attrs(ck.data_path(100))["striped"]["files"]
    group, name = files[2]            # holds optimizer-state bytes only
    (hdfs.root / f"group{group:02d}" / name).unlink()
    rt = _runtime(pkg, reg, hdfs, tmp_path / "wd")
    rt.run_startup(_spec(pkg), checkpointer=ck)    # params wave reads fine
    with pytest.raises(mod(pkg, "dfs.striped").StripeMissingError):
        rt.drain_deferred()
    rt.close()


def test_hot_record_created_once_as_the_reference(tmp_path):
    hot = []
    for pkg in PKGS:
        reg, hdfs, ck = _inputs(pkg, tmp_path / pkg)
        rt = _runtime(pkg, reg, hdfs, tmp_path / pkg / "w")
        man = reg.get_manifest("img")
        assert not rt.hot_service.has_record(man.digest)
        rt.run_startup(_spec(pkg), checkpointer=ck)
        assert rt.hot_service.has_record(man.digest)
        hot.append(rt.hot_service.hot_blocks(man.digest))
        assert 0 < len(hot[-1]) <= len(man.unique_blocks)
        rt.close()
    assert hot[0] == hot[1]


def test_analysis_service_accumulates_runs_as_the_reference(tmp_path):
    jobs = []
    for pkg in PKGS:
        reg, hdfs, ck = _inputs(pkg, tmp_path / pkg)
        rt = _runtime(pkg, reg, hdfs, tmp_path / pkg / "w")
        for _ in range(2):
            rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
        jobs.append(rt.analysis.jobs())
        rt.close()
    assert jobs[0] == jobs[1] and len(jobs[1]) == 2


# ------------------------------------------------------------ tuning ---

def _tune_runtime(pkg, reg, hdfs, workdir, **kw):
    """A tuning runtime; the port's sweeps the plain versions on the CPU
    (its default is the card's compiled configs)."""
    if pkg == "repro_torch":
        kw.setdefault("tune_backend", "cpu")
    return _runtime(pkg, reg, hdfs, workdir, tune=True, **kw)


def _tune_notes(res) -> dict:
    notes = res.notes
    return {"hit": notes["tune_cache_hit"],
            "invocations": notes["tune_invocations"],
            "digest": "tune_profile_digest" in notes,
            "error": notes.get("tune_error")}


def test_tune_warm_boot_hits_with_zero_invocations_as_the_reference(
        tmp_path):
    """tests/test_tune.py::TestBootRoundTrip on both runtimes: the cold boot
    sweeps the tiny workloads and publishes, the warm boot fetches the same
    digest with no sweep; each note as the JAX runtime's on the same job."""
    seen = {}
    for pkg in PKGS:
        reg, hdfs, ck = _inputs(pkg, tmp_path / pkg, throttled=False)
        with _tune_runtime(pkg, reg, hdfs, tmp_path / pkg / "w") as rt:
            cold = rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
            rt.drain_deferred()
            warm = rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
            rt.drain_deferred()
            assert warm.notes["tune_profile_digest"] == \
                cold.notes["tune_profile_digest"]
            seen[pkg] = (_tune_notes(cold), _tune_notes(warm),
                         rt.tune_store.stats["publishes"],
                         rt.mount.exists("tune/HEAD"))
    assert seen["repro_torch"] == seen["repro"]
    assert seen["repro_torch"] == (
        {"hit": False, "invocations": 2, "digest": True, "error": None},
        {"hit": True, "invocations": 0, "digest": True, "error": None},
        1, True)


def test_tune_corrupt_dfs_profile_does_not_crash_the_boot(tmp_path):
    """A dangling HEAD on the DFS: the next boot completes, re-tunes and
    re-publishes, as the reference's."""
    seen = {}
    for pkg in PKGS:
        reg, hdfs, ck = _inputs(pkg, tmp_path / pkg, throttled=False)
        with _tune_runtime(pkg, reg, hdfs, tmp_path / pkg / "w") as rt:
            rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
            rt.drain_deferred()
            rt.mount.write("tune/HEAD", b"deadbeef")
            res = rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
            rt.drain_deferred()
            assert res.total_s > 0
            seen[pkg] = (_tune_notes(res), rt.tune_store.stats["publishes"],
                         rt.tune_store.stats["rejects"])
    assert seen["repro_torch"] == seen["repro"] == (
        {"hit": False, "invocations": 2, "digest": True, "error": None}, 2, 1)


def test_tune_restore_is_off_the_critical_path_as_the_reference(tmp_path):
    """The tuning task is non-gating on rank 0: stages, tasks, chains and
    the scheduler's bytes as the reference's runtime gives them, but for
    the profile's own (its JSON differs between the packages: backend,
    keys, times), which the store meters DEFERRED."""
    out = []
    for pkg in PKGS:
        reg, hdfs, ck = _inputs(pkg, tmp_path / pkg)
        with _tune_runtime(pkg, reg, hdfs, tmp_path / pkg / "w") as rt:
            runs = []
            for _ in range(2):
                summary = _summary(rt.run_startup(_spec(pkg),
                                                  checkpointer=ck), rt)
                moved = (rt.tune_store.stats["bytes_written"]
                         + rt.tune_store.stats["bytes_read"])
                assert moved > 0
                summary["io"]["dfs"]["deferred"] -= moved
                # the registry's critical bytes, as before; a block's "peer"
                # bytes depend on which node's thread won its singleflight
                summary["image_critical"].pop("peer", None)
                runs.append(summary)
            out.append(runs)
    assert out[0] == out[1]
    for summary in out[1]:
        assert all("tune.restore" not in chain
                   for chain in summary["chains"].values())


def test_tune_boot_installs_its_profile_for_the_kernels(tmp_path):
    """The warm boot's profile is the ambient one the kernels' resolution
    reads (kernels/ops.py), with the entries the cold boot swept."""
    from repro_torch.tune.profile import get_active_profile, set_active_profile
    reg, hdfs, ck = _inputs("repro_torch", tmp_path, throttled=False)
    try:
        with _tune_runtime("repro_torch", reg, hdfs, tmp_path / "w") as rt:
            rt.run_startup(_spec("repro_torch", n=2), checkpointer=ck)
            rt.drain_deferred()
            set_active_profile(None)
            res = rt.run_startup(_spec("repro_torch", n=2), checkpointer=ck)
            rt.drain_deferred()
            prof = get_active_profile()
            assert prof is not None and prof.store is rt.tune_store
            assert prof.digest() == res.notes["tune_profile_digest"]
            assert sorted(k.split("|")[0] for k in prof.entries) == \
                ["flash_attention", "ssd"]
    finally:
        set_active_profile(None)


def test_a_failed_sweep_is_a_note_not_a_crash(tmp_path):
    """The port's default sweeps on the card; without one the boot still
    completes, and the note says why nothing was tuned."""
    reg, hdfs, ck = _inputs("repro_torch", tmp_path, throttled=False)
    with _runtime("repro_torch", reg, hdfs, tmp_path / "w", tune=True) as rt:
        res = rt.run_startup(_spec("repro_torch", n=2), checkpointer=ck)
        rt.drain_deferred()
    notes = _tune_notes(res)
    assert notes["hit"] is False and notes["invocations"] == 0
    assert not notes["digest"] and "CUDA" in notes["error"]


@pytest.mark.parametrize("pkg", PKGS)
def test_tune_needs_the_optimized_runtime(tmp_path, pkg):
    """The baseline runtime runs no tuning task and writes no tune notes."""
    reg, hdfs, ck = _inputs(pkg, tmp_path, throttled=False)
    with _tune_runtime(pkg, reg, hdfs, tmp_path / "w", optimize=False) as rt:
        res = rt.run_startup(_spec(pkg, n=2), checkpointer=ck)
    assert rt.tune is False and rt.tune_store is None
    assert not any(k.startswith("tune_") for k in res.notes)


# ------------------------------------------------------ launch profiles ---

def test_launch_profile_tracks_the_card_environment():
    env = {"CUDA_VISIBLE_DEVICES": "0", "CUDA_HOME": "/usr/local/cuda",
           "LD_PRELOAD": "/usr/lib/libtcmalloc.so.4",
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "XLA_FLAGS": "--x"}
    doc = capture_launch_profile(environ=env).to_json()
    jdoc = mod("repro", "tune.launchprofile").capture_launch_profile(
        environ=env).to_json()
    assert set(doc) == set(jdoc) and doc["version"] == jdoc["version"]
    assert set(doc["env"]) == set(TRACKED_ENV_VARS)
    assert doc["env"]["PYTORCH_CUDA_ALLOC_CONF"] is None
    assert profile_drift(doc, environ=dict(env)) == []
    assert profile_drift(doc, environ={**env, "XLA_FLAGS": "--y"}) == []
    assert profile_drift(doc, environ={**env, "CUDA_VISIBLE_DEVICES": "1"}) \
        == ["CUDA_VISIBLE_DEVICES: snapshot '0' != current '1'"]
    assert profile_drift({"version": 99}) == [
        "invalid launch profile: unsupported launch profile: "
        "{'version': 99}"]


def test_runtime_reports_drift_of_a_changed_cuda_variable(tmp_path,
                                                          monkeypatch):
    """The env snapshot carries the launch profile it was made under; a
    later boot in another environment reports the changed variable and
    nothing else."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    reg, hdfs, ck = _inputs("repro_torch", tmp_path)
    rt = _runtime("repro_torch", reg, hdfs, tmp_path / "w")
    assert rt.run_startup(_spec("repro_torch", n=2)).notes[
        "launch_profile_drift"] == {}
    rt.close()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    rt = _runtime("repro_torch", reg, hdfs, tmp_path / "w")
    drift = rt.run_startup(_spec("repro_torch", n=2)).notes[
        "launch_profile_drift"]
    rt.close()
    assert drift == {node: ["CUBLAS_WORKSPACE_CONFIG: snapshot ':4096:8' != "
                            "current ':16:8'"]
                     for node in ("node000", "node001")}


# --------------------------------------------------------- the launchers ---

def _boot_line(out: str, key: str = "boot") -> dict:
    (line,) = [ln for ln in out.splitlines() if ln.startswith(key + ": ")]
    return json.loads(line[len(key) + 2:])


def test_train_cli_boots_cold_then_warm_and_resumes(tmp_path, capsys,
                                                    monkeypatch):
    from repro_torch.launch import train as train_cli
    calls = []
    real = train_cli._cpu_env_setup

    def spy(target, rank):
        calls.append(rank)
        real(target, rank)

    monkeypatch.setattr(train_cli, "_cpu_env_setup", spy)
    args = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq-len",
            "16", "--workdir", str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(args)
    cold = capsys.readouterr().out
    assert "== startup (BootSeer, cold) ==" in cold and "(cold)" in cold
    assert sorted(calls) == [0, 1]
    assert "cold start" in cold and "checkpoint @ step 2 (full" in cold
    assert _boot_line(cold)["prefetch_used"] is False

    train_cli.main(args)
    warm = capsys.readouterr().out
    assert sorted(calls) == [0, 1]          # the env came from the cache
    boot_ = _boot_line(warm)
    assert "== startup (BootSeer, resume@2) ==" in warm
    assert boot_["prefetch_used"] is True
    assert boot_["io_bytes"]["dfs"]["critical"] > 0
    assert "resuming params/opt from step 2" in warm and "steps 2-3" in warm
    for n in range(2):
        restored = tmp_path / "rt" / "train-qwen2.5-3b_r0" / f"n{n}" / \
            "site-packages"
        assert sorted(p.name for p in restored.iterdir()) == [
            f"dep{i}.py" for i in range(8)]
    end = _boot_line(warm, "boot-end")
    assert end["nvcc_builds"] == [] and not any(end["launches"].values())


def test_serve_cli_boots_twice_with_the_same_greedy_tokens(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    args = ["--device", "cpu", "--arch", "qwen2.5-3b", "--requests", "3",
            "--new-tokens", "4", "--batch", "2", "--cache-len", "32",
            "--workdir", str(tmp_path)]
    runs = []
    for _ in range(2):
        serve_cli.main(args)
        runs.append(capsys.readouterr().out)
    assert "seeded checkpoint step 0" in runs[0] and "(cold)" in runs[0]
    assert "seeded" not in runs[1] and "(warm)" in runs[1]
    tokens = [_boot_line(out, "boot-end")["greedy_tokens"] for out in runs]
    assert tokens[0] == tokens[1] and len(tokens[0]) == 2
    assert all(len(t) == 4 for t in tokens[0])
    assert "first token" in runs[1]


def _fake_kernel_build(calls: list):
    """A stand-in for ``build.build`` that records its directory and
    writes a library whose bytes are drawn from a seed."""
    def fake(directory=None):
        calls.append(Path(directory))
        lib = Path(directory) / f"libkernels-{build.source_hash()}.so"
        if not lib.exists():
            lib.parent.mkdir(parents=True, exist_ok=True)
            lib.write_bytes(np.random.default_rng(3).integers(
                0, 256, 50_000, dtype=np.uint8).tobytes())
            lib.with_suffix(".log").write_text("ptxas info    : Used 8 registers")
        return build.KernelLibrary(None, lib, "")
    return fake


def test_card_environment_is_the_kernel_library(tmp_path, monkeypatch,
                                                capsys):
    """On the card the job's environment is the kernel library: the cold
    boot builds it into the env target (and only there), the key carries
    the sources' hash, and a warm boot on a fresh node restores it, byte
    for byte, and loads it from there without building."""
    calls = []
    monkeypatch.setattr(build, "build", _fake_kernel_build(calls))
    cpu = {"arch": "qwen2.5-3b", "deps": ["framework==2.1"]}
    env_setup, params = boot.environment(True, cpu, cpu_setup=None)
    assert params == {**cpu, "kernels": build.source_hash()}
    assert boot.environment(False, cpu, cpu_setup=print) == (print, cpu)

    reg, hdfs, _ = _inputs("repro_torch", tmp_path)
    spec = JobSpec(job_id="train-x", image="img", num_nodes=1,
                   job_params=params, startup_reads=[("bin/start", 0, -1)],
                   env_setup=env_setup)
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "rt")
    res = rt.run_startup(spec)
    rt.close()
    target = boot.env_target(rt, res) / boot.KERNELS_DIR
    assert calls == [target]
    built = _files(target)
    assert set(built) == {f"libkernels-{build.source_hash()}.so",
                          f"libkernels-{build.source_hash()}.log"}

    # a fresh node: nothing of the cold boot's environment is left on it
    import shutil
    shutil.rmtree(boot.env_target(rt, res))
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "rt")
    res = rt.run_startup(spec)
    assert res.notes["prefetch_used"] and calls == [target]
    boot.load_kernels(rt, res)
    rt.close()
    assert calls == [target, target]
    assert _files(target) == built
    lib = f"libkernels-{build.source_hash()}.so"
    assert capsys.readouterr().out.strip().endswith(
        "sha256 " + __import__("hashlib").sha256(built[lib][0]).hexdigest())


# ------------------------------------------------------------ witnesses ---

@pytest.fixture
def port_lock_witness():
    """The port's lock witness, for this test only: locks the port
    constructs meanwhile record their acquisition orders."""
    from repro_torch.analysis import witness
    saved = (witness.RECORDER, {n: getattr(threading, n) for n in witness._REAL})
    witness.install()
    try:
        yield witness
    finally:
        witness.RECORDER = saved[0]
        for name, ctor in saved[1].items():
            setattr(threading, name, ctor)


def test_lock_witness_sees_no_cycle_in_port_boots(tmp_path,
                                                  port_lock_witness):
    """A pipelined two-node cold boot with a resume, a restore-ahead, a
    warm boot, and a fresh runtime's boot served from the restore-ahead
    entries take the port's locks in no inverted order; a planted
    inversion of two of them is caught."""
    witness = port_lock_witness
    reg, hdfs, ck = _inputs("repro_torch", tmp_path, opt=True,
                            throttled=False)
    spec = _spec("repro_torch", n=2)
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "w")
    rt.run_startup(spec, checkpointer=ck)
    rt.restore_ahead(spec, ck, 100)
    rt.drain_deferred()
    rt.run_startup(spec, checkpointer=ck)
    rt.drain_deferred()
    rt.close()
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "w")
    res = rt.run_startup(spec, checkpointer=ck)
    rt.drain_deferred()
    # the restore-ahead entries outlive the runtime on node-local disk
    assert res.notes["restore_ahead_hit_bytes"] > 0
    rec = witness.RECORDER
    roots = [ROOT / "src" / "repro_torch"]
    report = witness.cross_check(rec, roots=roots)
    assert report["cycles"] == []
    assert report["locks_witnessed"] >= 8 and report["observed_edges"]

    a, b = rt.env_cache._flight_master, rt.io_sched._master
    assert all(isinstance(x, witness._Witnessed) for x in (a, b))
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = witness.cross_check(rec, roots=roots)["cycles"]
    rt.close()
    assert len(cycles) == 1 and {"EnvCache._flight_master",
                                 "IOScheduler._master"} <= set(cycles[0])


@pytest.fixture
def io_witness(monkeypatch):
    return torch_io_witness.install(monkeypatch)


def test_every_boot_byte_is_read_in_a_slot(tmp_path, io_witness):
    """Cold and warm boots with a resume, then a fresh runtime's boot (a
    new process): every DFS byte (checkpoint waves, env archive and its
    meta) and every registry byte (image blocks) is read inside a slot of
    its resource, at the priorities the scheduler metered."""
    reg, hdfs, ck = _inputs("repro_torch", tmp_path, opt=True,
                            throttled=False)
    spec = _spec("repro_torch", n=2)
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "w")
    for _ in range(2):
        rt.run_startup(spec, checkpointer=ck)
        rt.drain_deferred()
    io_witness.check_scheduler(rt.io_sched)
    assert io_witness.registry and len(io_witness.read) == 2
    rt.close()

    io_witness.read.clear()
    io_witness.registry.clear()
    rt = BootseerRuntime(registry=reg, hdfs=hdfs, workdir=tmp_path / "w")
    rt.run_startup(spec, checkpointer=ck)
    rt.drain_deferred()
    io_witness.check_scheduler(rt.io_sched)
    key = next(iter(rt.env_cache._meta_cache))
    meta_bytes = hdfs.size(rt.env_cache.mount._full(
        rt.env_cache._meta_path(key)))
    assert io_witness.read[CRITICAL] > meta_bytes > 0

    # the JAX package's copy reads the meta outside the scheduler: planted
    # here, the witness catches it
    rt.env_cache.mount.open(rt.env_cache._meta_path(key)).read()
    rt.close()
    with pytest.raises(AssertionError, match="outside any dfs slot"):
        io_witness.check_scheduler(rt.io_sched)


def test_a_warm_tuning_boot_reads_its_profile_in_deferred_slots(
        tmp_path, io_witness):
    """A fresh runtime's warm boot (a new process) fetches the profile a
    cold boot published: the profile's bytes, with every other DFS and
    registry byte, read inside slots at the priorities the scheduler
    metered, the profile's DEFERRED; nothing written to the DFS."""
    from repro_torch.core.pipeline import DEFERRED
    from repro_torch.tune.profile import set_active_profile
    reg, hdfs, ck = _inputs("repro_torch", tmp_path, opt=True,
                            throttled=False)
    spec = _spec("repro_torch", n=2)
    try:
        with _tune_runtime("repro_torch", reg, hdfs, tmp_path / "w") as rt:
            rt.run_startup(spec, checkpointer=ck)
            rt.drain_deferred()
        for ledger in (io_witness.read, io_witness.written,
                       io_witness.registry):
            ledger.clear()
        with _tune_runtime("repro_torch", reg, hdfs, tmp_path / "w") as rt:
            res = rt.run_startup(spec, checkpointer=ck)
            rt.drain_deferred()
            io_witness.check_scheduler(rt.io_sched, writes=True)
            fetched = rt.tune_store.stats["bytes_read"]
    finally:
        set_active_profile(None)
    assert res.notes["tune_cache_hit"] and io_witness.written == {}
    assert io_witness.read[DEFERRED] >= fetched > 0
