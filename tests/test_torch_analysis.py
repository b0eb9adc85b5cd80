"""The port's lint and witnesses (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

Every known-bad and known-good fixture of ``tests/test_analysis.py`` is
linted by both packages, which must find the same things (check,
function, line, detail, chain, fingerprint), and the one expected; the
port's lint on ``src/repro`` finds what the reference's does, and on
``src/repro_torch`` exactly ``analysis_baseline_torch.json``'s four
reviewed findings. The witnesses keep the port's frames, patch the port's
classes, and a port boot with a resume runs under both, as a user runs
it: ``python -m repro_torch.analysis.witness repro_torch.launch.train``.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from repro.analysis import iochecks as jiochecks
from repro.analysis.callgraph import Package as JPackage
from repro.analysis.checks import run_checks as jrun_checks
from repro.analysis.cli import run_analysis as jrun_analysis
from repro.analysis.lockorder import build_lock_order as jbuild_lock_order
from repro.analysis.locks import collect_locks as jcollect_locks
from repro_torch.analysis import iochecks, iowitness, witness
from repro_torch.analysis.callgraph import Package
from repro_torch.analysis.checks import run_checks
from repro_torch.analysis.cli import main as lint_main
from repro_torch.analysis.cli import run_analysis
from repro_torch.analysis.lockorder import build_lock_order, scc_cycles
from repro_torch.analysis.locks import collect_locks

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"

# the fixture classes of tests/test_analysis.py and, for each fixture,
# the one check it must trip (None: it must lint clean)
FIXTURE_CLASSES = ("TestKnownBad", "TestKnownGood", "TestIOKnownBad",
                   "TestIOKnownGood", "TestTuneRoots")
EXPECTED = {
    "test_lock_order_cycle": "lock-order-cycle",
    "test_sleep_under_lock": "blocking-under-lock",
    "test_sleep_under_lock_propagated_through_calls": "blocking-under-lock",
    "test_token_leak_on_raise": "leak-on-raise",
    "test_reentrant_acquire": "reentrant-acquire",
    "test_slot_outside_with": "slot-outside-with",
    "test_unused_lock": "unused-lock",
    "test_unbounded_lock_container": "unbounded-lock-container",
    "test_try_finally_release_is_clean": None,
    "test_singleflight_with_retire_is_clean": None,
    "test_semaphore_hold_not_flagged_as_blocking": None,
    "test_cond_wait_on_held_condition_is_clean": None,
    "test_priority_drop_unused_param": "io-priority-drop",
    "test_priority_drop_reader_without_sched": "io-priority-drop",
    "test_unscheduled_io_from_startup_task": "unscheduled-io",
    "test_unscheduled_io_propagates_through_helpers": "unscheduled-io",
    "test_accounting_gap": "io-accounting-gap",
    "test_per_call_executor_on_startup_path": "executor-hygiene",
    "test_untimed_result_on_startup_path": "executor-hygiene",
    "test_forwarded_priority_is_clean": None,
    "test_reader_with_sched_is_clean": None,
    "test_slot_token_discharges_unscheduled_io": None,
    "test_accounting_only_design_is_clean": None,
    "test_sibling_method_accounting_is_clean": None,
    "test_module_singleton_pool_is_clean": None,
    "test_per_call_executor_in_tune_is_flagged": "executor-hygiene",
    "test_singleton_pool_in_tune_is_clean": None,
    "test_untimed_result_in_tune_is_flagged": "executor-hygiene",
    "test_unscheduled_profile_read_in_tune_is_flagged": "unscheduled-io",
    "test_metered_profile_read_in_tune_is_clean": None,
}


def _reference_fixtures() -> dict:
    """{test name: (relative path, source)} of every ``lint_source`` /
    ``lint_tree`` call in the reference's fixture classes."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = {}
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in FIXTURE_CLASSES):
            continue
        for fn in cls.body:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name) and node.func.id in (
                        "lint_source", "lint_tree"):
                    args = [ast.literal_eval(a) for a in node.args[1:]]
                    rel = "mod.py" if node.func.id == "lint_source" \
                        else args[0]
                    out[fn.name] = (rel, args[-1])
    return out


FIXTURES = _reference_fixtures()


def _lint(tmp: Path, rel: str, src: str, port: bool):
    """(findings as dicts, lock-order pairs) of one fixture file linted
    by the port (``port``) or the reference, as test_analysis.py lints;
    the paths in the findings are relative to ``tmp``."""
    root = tmp / "fixture"
    f = root / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(src))
    if port:
        pkg = Package.load([f], package_root=root)
        table = collect_locks(pkg)
        graph = build_lock_order(pkg, table)
        found = run_checks(pkg, table, graph) + iochecks.run_io_checks(pkg)
    else:
        pkg = JPackage.load([f], package_root=root)
        table = jcollect_locks(pkg)
        graph = jbuild_lock_order(pkg, table)
        found = jrun_checks(pkg, table, graph) + jiochecks.run_io_checks(pkg)
    return [x.to_dict() for x in found], graph.pairs()


def test_every_reference_fixture_is_covered():
    assert set(FIXTURES) == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_lints_as_the_reference(name, tmp_path):
    rel, src = FIXTURES[name]
    ours, our_pairs = _lint(tmp_path / "port", rel, src, port=True)
    ref, ref_pairs = _lint(tmp_path / "ref", rel, src, port=False)
    assert ours == ref and our_pairs == ref_pairs
    assert [f["check"] for f in ours] == (
        [EXPECTED[name]] if EXPECTED[name] else [])


@pytest.mark.parametrize("name", sorted(n for n, (rel, _) in FIXTURES.items()
                                        if rel.startswith("repro/tune/")))
def test_tune_fixture_roots_the_ports_tune(name, tmp_path):
    """Under ``repro_torch/tune/`` a fixture is a root for the port as
    ``repro/tune/`` is for the reference: the same findings, under the
    port's module names."""
    rel, src = FIXTURES[name]
    ours, _ = _lint(tmp_path / "port", rel.replace("repro/", "repro_torch/"),
                    src, port=True)
    ref, _ = _lint(tmp_path / "ref", rel, src, port=False)
    key = ("check", "function", "line", "detail", "chain")
    assert [[json.dumps(f[k]).replace("repro_torch.", "repro.")
             for k in key] for f in ours] == \
        [[json.dumps(f[k]) for k in key] for f in ref]
    assert all("repro_torch.tune." in f["function"] for f in ours)


# ---------------------------------------------------------------------------
# the source trees
# ---------------------------------------------------------------------------

def test_port_lints_the_reference_as_the_reference():
    ours = run_analysis(roots=[ROOT / "src" / "repro"])
    ref = jrun_analysis()
    assert [f.to_dict() for f in ours.findings] == \
        [f.to_dict() for f in ref.findings]
    assert ours.graph.pairs() == ref.graph.pairs()
    assert {k: (d.kind, d.file, d.line) for k, d in ours.table.defs.items()} \
        == {k: (d.kind, d.file, d.line) for k, d in ref.table.defs.items()}


def test_port_is_clean_beyond_its_baseline():
    rep = run_analysis(baseline_path=ROOT / "analysis_baseline_torch.json")
    assert rep.new == [], "un-baselined findings:\n" + \
        "\n".join(f.format() for f in rep.new)
    assert rep.stale == []
    assert len(rep.suppressed) == 4
    assert rep.graph.cycles() == []


def test_port_baseline_is_the_reference_reviewed_one():
    """The four suppressions are the reference's, under the port's names,
    each with its justification."""
    ours = json.loads((ROOT / "analysis_baseline_torch.json").read_text())
    ref = json.loads((ROOT / "analysis_baseline.json").read_text())

    def key(e, pkg):
        return (e["check"], e["file"].replace(f"src/{pkg}/", ""),
                e["function"].replace(f"{pkg}.", "", 1), e["detail"],
                e["justification"])
    assert sorted(key(e, "repro_torch") for e in ours["suppressions"]) == \
        sorted(key(e, "repro") for e in ref["suppressions"])


def test_the_ports_tune_is_a_root():
    """The tuning root follows the linted package's name: the port's
    lint roots ``repro_torch.tune``, the reference's literal marker does
    not."""
    pkg = Package.load([PORT_SRC], exclude_parts=("analysis",))
    tune = [q for q in pkg.functions if q.startswith("repro_torch.tune.")]
    assert tune and all(iochecks._is_root(q) for q in tune)
    assert not any(jiochecks._is_root(q) for q in tune)
    assert not iochecks._is_root("repro_torch.dfs.striped:StripedReader.read")


def test_cli_defaults_to_the_port(capsys):
    rc = lint_main(["--baseline", str(ROOT / "analysis_baseline_torch.json"),
                    "--format", "json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert rep["summary"] == {"total": 4, "new": 0, "suppressed": 4,
                              "stale_baseline_entries": 0}
    assert all(v["file"].startswith("src/repro_torch/")
               for v in rep["locks"].values())
    assert not any("/analysis/" in v["file"] for v in rep["locks"].values())


# ---------------------------------------------------------------------------
# the witnesses
# ---------------------------------------------------------------------------

def test_lock_factory_scopes_to_the_ports_sources():
    saved = {n: getattr(threading, n) for n in witness._REAL}
    old_rec = witness.RECORDER
    witness.install()
    try:
        made = {}
        for where in ("src/repro_torch/fake.py", "src/repro/fake.py",
                      "src/repro_torch/analysis/fake.py"):
            ns = {}
            exec(compile("import threading\nlk = threading.Lock()\n",
                         "/somewhere/" + where, "exec"), ns)
            made[where] = ns["lk"]
        assert isinstance(made["src/repro_torch/fake.py"], witness.WitnessLock)
        assert made["src/repro_torch/fake.py"]._site == (
            "src/repro_torch/fake.py", 2)
        assert not isinstance(made["src/repro/fake.py"], witness._Witnessed)
        assert not isinstance(made["src/repro_torch/analysis/fake.py"],
                              witness._Witnessed)
    finally:
        for n, v in saved.items():
            setattr(threading, n, v)
        witness.RECORDER = old_rec


def test_opposite_orders_make_a_cycle():
    rec = witness.Recorder()
    old = witness.RECORDER
    witness.RECORDER = rec
    try:
        a = witness.WitnessLock(threading.Lock(), ("x.py", 1))
        b = witness.WitnessLock(threading.Lock(), ("x.py", 2))
        for first, second in ((a, b), (b, a)):
            with first:
                with second:
                    pass
    finally:
        witness.RECORDER = old
    pairs = {(f"{s[0]}:{s[1]}", f"{t[0]}:{t[1]}") for s, t in rec.edges}
    assert scc_cycles(pairs) == [["x.py:1", "x.py:2"]]


def test_io_witness_patches_the_ports_classes(tmp_path):
    from repro.dfs.hdfs import HdfsCluster as JHdfs
    from repro_torch.core.pipeline import CRITICAL, DEFERRED, IOScheduler
    from repro_torch.dfs.hdfs import HdfsCluster
    rec = iowitness.install()
    try:
        assert JHdfs.pread is not HdfsCluster.pread
        hdfs = HdfsCluster(tmp_path / "h", num_groups=2, block_size=1 << 16)
        hdfs.write("/f", b"x" * 1000)
        sched = IOScheduler()
        with sched.slot("dfs", priority=CRITICAL, nbytes=1000):
            assert hdfs.read("/f") == b"x" * 1000
        with sched.slot("dfs", priority=DEFERRED, nbytes=10):
            assert hdfs.pread("/f", 0, 10) == b"x" * 10
        with hdfs.open_group_file(0, "raw.bin", "wb") as h:
            h.write(b"y" * 300)
    finally:
        iowitness.uninstall()
    rep = iowitness.reconcile(rec)
    assert rep["observed_read"] == rep["accounted_read"] == 1010
    assert rep["sched_bytes_by_resource"] == {
        "dfs": {"critical": 1000, "deferred": 10}}
    assert not rep["ok"] and rep["unaccounted_write"] == 300
    assert rep["inversions"] == []


def test_io_witness_names_the_ports_reader():
    src = (PORT_SRC / "dfs" / "striped.py").read_text()
    line = next(i for i, ln in enumerate(src.splitlines(), 1)
                if "def _read_subs" in ln) + 2
    site = ("src/repro_torch/dfs/striped.py", line)
    assert iowitness.site_functions([site])[site] == \
        "repro_torch.dfs.striped:StripedReader._read_subs"


def test_witnessed_boot_with_a_resume(tmp_path):
    """A pipelined two-node boot of the training launcher, cold, then
    warm with a resume from its checkpoint, each in a fresh process with
    both witnesses installed before the port's imports: no lock-order
    cycle, every byte accounted, no priority inversion."""
    args = [sys.executable, "-m", "repro_torch.analysis.witness",
            "repro_torch.launch.train", "--device", "cpu", "--nodes", "2",
            "--steps", "3", "--batch", "2", "--seq-len", "32",
            "--ckpt-every", "2", "--workdir", str(tmp_path / "job")]
    reports = []
    for _ in range(2):
        run = subprocess.run(args, capture_output=True, text=True,
                             cwd=ROOT, timeout=300,
                             env={**os.environ,
                                  "PYTHONPATH": str(ROOT / "src")})
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        line = next(ln for ln in run.stdout.splitlines()
                    if ln.startswith("witness-report: "))
        reports.append((run.stdout, json.loads(line[len("witness-report: "):])))
    (cold_out, cold), (warm_out, warm) = reports
    assert "resuming params/opt from step 2" in warm_out
    for rep in (cold, warm):
        assert rep["locks"]["cycles"] == []
        assert rep["io"]["ok"] and rep["io"]["inversions"] == []
        assert rep["io"]["unaccounted_read"] == 0
        assert rep["io"]["unaccounted_write"] == 0
    # the module-level locks are witnessed too: installed before import
    assert warm["locks"]["locks_witnessed"] > cold["locks"]["locks_witnessed"] - 1 >= 8
    dfs = warm["io"]["sched_bytes_by_resource"]["dfs"]
    assert dfs["critical"] > 0 and dfs["deferred"] > 0
    assert warm["io"]["observed_read"] > dfs["critical"] + dfs["deferred"]
    assert "witness: locks witnessed" in warm_out
