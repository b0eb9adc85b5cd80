"""The port's checkpoint stack against the JAX package's: the copied DFS,
placements, manifest and planner, the torch ``Checkpointer`` (each package
restores the other's files, full and delta, under every placement), the
training loop's save and resume, ``ServeEngine.from_checkpoint``, and the
I/O discipline of a scheduled restore, on tiny qwen2.5-3b on the CPU.

The reference runs on an Auto-axis (1, 1) mesh (its ``rules`` fixture's
Explicit axes raise on this JAX). Restores are compared bit for bit: the
same bytes go through both packages. A resumed run is compared bit for
bit with the uninterrupted one (the CPU's torch ops give the same bits for
the same inputs); against the reference's continuation the losses agree
to 2e-4 (fp32 arithmetic in another order, as tests/test_torch_train.py).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_io_witness
from jax.sharding import AxisType, PartitionSpec

from repro.ckpt import plan as jplan
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.ckpt.index import TensorIndex as JTensorIndex
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.dfs.hdfs import HdfsCluster as JHdfs
from repro.fabric.placement import Placement as JPlacement
from repro.models.model import Model as JModel
from repro.optim.adamw import adamw_init as jadamw_init
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import make_rules
from repro.train.loop import train_loop as jtrain_loop
from repro_torch.ckpt import plan
from repro_torch.ckpt.checkpoint import Checkpointer, flat_with_names
from repro_torch.ckpt.index import TensorIndex
from repro_torch.configs import get_config, reduced
from repro_torch.core.pipeline import CRITICAL, IOScheduler
from repro_torch.dfs.fuse import HdfsFuseMount
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.dfs.striped import StripedReader, StripeMissingError
from repro_torch.fabric.placement import Placement
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.loop import train_loop
from repro_torch.tune import (ProfileStore, TuningProfile,
                              get_active_profile)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
B, S = 2, 16
FP32_TOL = 2e-4
# small stripes, so a tiny checkpoint spreads over every stripe file
GEOMETRY = dict(width=4, chunk=4096, stripe=16384)


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def _pair(jax_rules, dtype: str):
    """(JAX model, JAX params, port model, port fp32 masters): the same
    weights, carried across as numpy."""
    jm = JModel(jreduced(jget_config(ARCH), dtype=dtype), jax_rules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype=dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jm, jp, Model(cfg, device="cpu"), tp


@pytest.fixture(scope="module")
def fp32_pair(jax_rules):
    return _pair(jax_rules, "float32")


def _trees(jp, tp):
    """The same three trees in both packages: fp32 masters, AdamW state
    (int32 step) and a bf16 copy of the masters (the same bits)."""
    jbf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tbf = tree_map(lambda t: t, jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x).view(np.uint16).copy())
        .view(torch.bfloat16), jbf))
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    jopt = dict(jopt, step=jnp.int32(7))
    topt["step"].fill_(7)
    return (jp, jopt, jbf), (tp, topt, tbf)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes, from either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _assert_same_trees(port_trees, jax_trees):
    for t, j in zip(port_trees, jax_trees):
        port = flat_with_names(t)
        ref = [(jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_flatten_with_path(j)[0]]
        assert [n for n, _ in port] == [n for n, _ in ref]
        for (name, a), (_, b) in zip(port, ref):
            assert tuple(a.shape) == np.shape(b), name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _manifest(index) -> list:
    return [(e.name, e.dtype, tuple(e.shape), e.offset)
            for e in index.entries_by_offset()]


def _data(hdfs, path: str) -> bytes:
    if "striped" in hdfs.attrs(path):
        return StripedReader(hdfs, path).read_all()
    return hdfs.read(path)


# ------------------------------------------------------------- names ---

def test_entry_names_are_the_references_keystr(fp32_pair):
    _, jp, _, tp = fp32_pair
    (jtrees, ttrees) = _trees(jp, tp)
    for t, j in zip(ttrees, jtrees):
        assert [n for n, _ in flat_with_names(t)] == [
            jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(j)[0]]
    assert ("['layers']['wq']" in
            [n for n, _ in flat_with_names(tp)])


# ---------------------------------------------- files across packages ---

@pytest.mark.parametrize("striped", [True, False])
def test_both_packages_write_the_same_files(tmp_path, fp32_pair, striped):
    """Saving the same trees, the two packages write equal manifests (names,
    dtypes, shapes, offsets, chunk CRCs) and equal data streams."""
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    jh, th = JHdfs(tmp_path / "j"), HdfsCluster(tmp_path / "t")
    jck = JCheckpointer(jh, striped=striped, **GEOMETRY)
    ck = Checkpointer(th, striped=striped, **GEOMETRY)
    jidx, idx = jck.save(3, *jtrees), ck.save(3, *ttrees)
    assert _manifest(idx) == _manifest(jidx)
    assert {e.dtype for e in idx.entries.values()} == {
        "float32", "uint16", "int32"}
    assert idx.to_json() == jidx.to_json()
    assert _data(th, ck.data_path(3)) == _data(jh, jck.data_path(3))
    assert jh.read(jck.index_path(3)) == th.read(ck.index_path(3))


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path, fp32_pair):
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    jck = JCheckpointer(JHdfs(tmp_path / "a"), **GEOMETRY)
    jck.save(1, *jtrees)
    ck = Checkpointer(HdfsCluster(tmp_path / "a"), **GEOMETRY)
    got = ck.restore_planned(1, *ttrees)
    _assert_same_trees(got, jtrees)
    assert got[2]["embed"].dtype == torch.bfloat16
    assert got[1]["step"].dtype == torch.int32 and got[1]["step"].shape == ()

    ck2 = Checkpointer(HdfsCluster(tmp_path / "b"), **GEOMETRY)
    ck2.save(2, *ttrees)
    back = JCheckpointer(JHdfs(tmp_path / "b"), **GEOMETRY).restore_planned(
        2, *jtrees)
    _assert_same_trees(ttrees, back)


def _bump(tree, name: str, rows: slice, by: float):
    t = tree["layers"][name] if name in tree.get("layers", {}) else tree[name]
    t[rows] += by


def test_full_and_delta_chain_across_packages(tmp_path, fp32_pair):
    """A full save and two deltas: both packages write the same delta
    manifests and data, and each restores the other's chain to the
    newest values."""
    _, jp, _, tp = fp32_pair
    jp = jax.tree.map(np.array, jp)       # writable copies, both sides
    tp = tree_map(torch.clone, tp)
    jtrees, ttrees = (jp, jadamw_init(jp)), (tp, adamw_init(tp))
    jck = JCheckpointer(JHdfs(tmp_path / "j"), diff_chunk=1024, **GEOMETRY)
    ck = Checkpointer(HdfsCluster(tmp_path / "t"), diff_chunk=1024,
                      **GEOMETRY)
    jck.save(1, *jtrees)
    ck.save(1, *ttrees)
    for step, (name, rows) in ((2, ("embed", slice(0, 3))),
                               (3, ("w_up", slice(1, 2)))):
        jt = jp["layers"][name] if name in jp["layers"] else jp[name]
        jt[rows] += 1.0
        _bump(tp, name, rows, 1.0)
        jidx = jck.save_delta(step, *jtrees)
        idx = ck.save_delta(step, *ttrees)
        assert idx.to_json() == jidx.to_json()
        assert 0 < idx.delta["data_bytes"] < idx.total_bytes
        assert _data(ck.hdfs, ck.delta_data_path(step)) == _data(
            jck.hdfs, jck.delta_data_path(step))
    assert ck.steps() == [1, 2, 3]
    _assert_same_trees(ck.restore_planned(3, *ttrees), jtrees)
    jport = JCheckpointer(JHdfs(tmp_path / "t"), **GEOMETRY)
    _assert_same_trees(ttrees, jport.restore_planned(3, *jtrees))
    tjax = Checkpointer(HdfsCluster(tmp_path / "j"), **GEOMETRY)
    _assert_same_trees(tjax.restore_planned(3, *ttrees), jtrees)
    # nothing changed: an empty delta, which restores all the same
    idx = ck.save_delta(4, *ttrees)
    assert idx.delta["ranges"] == [] and idx.delta["data_bytes"] == 0
    _assert_same_trees(ck.restore_planned(4, *ttrees), jtrees)


def test_torn_save_is_not_a_resume_candidate(tmp_path, fp32_pair):
    _, _, _, tp = fp32_pair
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(1, tp)
    ck.save(2, tp)
    ck.hdfs.delete(ck.data_path(2))
    ck.hdfs.write(f"{ck.base}/step_junk.index.json", b"{}")
    assert ck.steps() == [1] and ck.latest_step() == 1


@pytest.mark.parametrize("kind", ["striped", "replicated", "erasure"])
@pytest.mark.parametrize("sizes", [(5000, 3, 70000, 4096, 1), (8192,) * 5,
                                   (100000,)])
def test_striped_writer_writes_the_references_files(tmp_path, kind, sizes):
    """The port's writer takes whole chunks from the caller's buffer
    without copying them; the stripe files, parity and attributes stay
    the reference's for any sequence of write sizes."""
    from repro.dfs.striped import StripedWriter as JWriter
    from repro_torch.dfs.striped import StripedWriter
    data = np.random.default_rng(len(sizes)).integers(
        0, 256, sum(sizes), dtype=np.uint8).tobytes()
    out = []
    for writer, hdfs, pl in (
            (JWriter, JHdfs(tmp_path / "j"), JPlacement),
            (StripedWriter, HdfsCluster(tmp_path / "t"), Placement)):
        placement = {"striped": None, "replicated": pl.replicated(1),
                     "erasure": pl.erasure(2)}[kind]
        with writer(hdfs, "/f", width=4, chunk=4096, stripe=16384,
                    placement=placement) as w:
            at = 0
            for n in sizes:
                w.write(data[at:at + n])
                at += n
        files = {p.relative_to(hdfs.root): p.read_bytes()
                 for p in sorted(Path(hdfs.root).glob("group*/*"))}
        out.append((hdfs.attrs("/f"), files))
    assert out[0] == out[1]
    assert StripedReader(HdfsCluster(tmp_path / "t"), "/f").read_all() == data


# ---------------------------------------------------------- placements ---

def _drop_first_stripe(hdfs, path: str) -> None:
    group, name = hdfs.attrs(path)["striped"]["files"][0]
    (Path(hdfs.root) / f"group{group:02d}" / name).unlink()


@pytest.mark.parametrize("kind", ["striped", "replicated", "erasure"])
def test_placements_across_packages(tmp_path, fp32_pair, kind):
    """Each placement written by the port restores in both packages; with
    a stripe file gone, replication fails over and erasure rebuilds it
    from parity (in both packages), plain striping raises."""
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    placement = {"striped": None, "replicated": Placement.replicated(1),
                 "erasure": Placement.erasure(2)}[kind]
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), placement=placement,
                      **GEOMETRY)
    ck.save(5, *ttrees)
    _assert_same_trees(ck.restore_planned(5, *ttrees), jtrees)
    _drop_first_stripe(ck.hdfs, ck.data_path(5))
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    if kind == "striped":
        with pytest.raises(StripeMissingError):
            ck.restore_planned(5, *ttrees)
        return
    _assert_same_trees(Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
                       .restore_planned(5, *ttrees), jtrees)
    _assert_same_trees(ttrees, jck.restore_planned(5, *jtrees))


def test_jax_erasure_checkpoint_rebuilds_in_the_port(tmp_path, fp32_pair):
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    jck = JCheckpointer(JHdfs(tmp_path / "h"),
                        placement=JPlacement.erasure(2), **GEOMETRY)
    jck.save(9, *jtrees)
    _drop_first_stripe(jck.hdfs, jck.data_path(9))
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    _assert_same_trees(ck.restore_planned(9, *ttrees), jtrees)
    assert ck.hdfs.fabric_stats["degraded_reads"] >= 1


# ------------------------------------------------------------- planner ---

PLAN_CASES = [
    ((64, 16), ("data", None), {"data": 4}, {"data": 1}),
    ((64, 16), (None, "model"), {"model": 4}, {"model": 3}),
    ((8, 32, 16), (("data", "model"), None, None), {"data": 2, "model": 2},
     {"data": 1, "model": 0}),
    ((8, 32, 16), (None, "data", "model"), {"data": 2, "model": 4},
     {"data": 1}),
    ((10, 6), ("data",), {"data": 4}, {"data": 2}),       # not divisible
    ((), None, {}, {}),
]


@pytest.mark.parametrize("shape,spec,sizes,coords", PLAN_CASES)
@pytest.mark.parametrize("gap", [0, 64 * 1024])
def test_restore_plans_equal_the_references(shape, spec, sizes, coords, gap):
    idxs = []
    for pkg_index in (TensorIndex, JTensorIndex):
        idx = pkg_index(meta={"step": 1})
        idx.add("t0['a']", np.float32, (3, 5))
        idx.add("t0['w']", np.float32, shape)
        idx.add("t1['w']#bf16", np.uint16, shape)
        idxs.append(idx)
    plans = []
    for pkg, idx in zip((plan, jplan), idxs):
        slices = {n: pkg.dim_slices_for_spec(spec, idx.entries[n].shape,
                                             sizes, coords)
                  for n in ("t0['w']", "t1['w']#bf16")}
        plans.append(pkg.build_restore_plan(idx, None, slices, gap=gap))
    mine, ref = plans
    assert [dataclasses.astuple(t) for t in mine.tensors] == [
        dataclasses.astuple(t) for t in ref.tensors]
    assert [(r.offset, r.length, [dataclasses.astuple(s) for s in r.segments])
            for r in mine.reads] == [
        (r.offset, r.length, [dataclasses.astuple(s) for s in r.segments])
        for r in ref.reads]
    assert (mine.payload_bytes, mine.planned_bytes) == (
        ref.payload_bytes, ref.planned_bytes)


def test_checkpointer_plans_equal_the_references(tmp_path, fp32_pair):
    """Both packages plan the same waves on one checkpoint; specs on a
    one-device mesh restore whole tensors, on a larger one the host's
    slices, the same slices and reads in both."""
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(4, *ttrees[:2])
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    specs = tree_map(lambda t: ("data",) if t.dim() else None, ttrees[0])
    jspecs = jax.tree.map(lambda x: PartitionSpec("data") if x.ndim else None,
                          jtrees[0])
    for kw, jkw in (({}, {}),
                    ({"specs": (specs,), "axis_sizes": {"data": 1}},
                     {"specs": (jspecs,), "axis_sizes": {"data": 1}})):
        _, plans = ck.plan_restore(4, *ttrees[:2], **kw)
        _, jplans = jck.plan_restore(4, *jtrees[:2], **jkw)
        assert [[t.name for t in p.tensors] for p in plans] == [
            [t.name for t in p.tensors] for p in jplans]
        assert [[(r.offset, r.length) for r in p.reads] for p in plans] == [
            [(r.offset, r.length) for r in p.reads] for p in jplans]
    # every spec is resolved to its entry, as the reference resolves it
    index = ck.load_index(4)
    mine = ck._dim_slices(index, ttrees[:2], specs=(specs,),
                          axis_sizes={"data": 1})
    assert mine == jck._dim_slices(index, jtrees[:2], specs=(jspecs,),
                                   axis_sizes={"data": 1})
    assert len(mine) == sum(1 for _, t in flat_with_names(ttrees[0])
                            if t.dim())
    sharded = dict(axis_sizes={"data": 2}, coords={"data": 1})
    _, plans = ck.plan_restore(4, *ttrees[:2], specs=(specs,), **sharded)
    _, jplans = jck.plan_restore(4, *jtrees[:2], specs=(jspecs,), **sharded)
    assert [[dataclasses.astuple(t) for t in p.tensors] for p in plans] == [
        [dataclasses.astuple(t) for t in p.tensors] for p in jplans]
    assert [[(r.offset, r.length) for r in p.reads] for p in plans] == [
        [(r.offset, r.length) for r in p.reads] for p in jplans]
    _, whole = ck.plan_restore(4, *ttrees[:2])
    assert plans[0].payload_bytes < whole[0].payload_bytes


def test_row_shards_restore_as_the_references(tmp_path, fp32_pair):
    """The legacy leading-dim row form: both packages restore the same
    rows of a tensor, the rest whole; a tree of another shape raises."""
    _, jp, _, tp = fp32_pair
    jtrees, ttrees = _trees(jp, tp)
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(6, *ttrees[:2])
    rows = {"t0['embed']": (2, 5), "t1['mu']['layers']['wq']": (1, 1)}
    got = ck.restore_planned(6, *ttrees[:2], shard_slices=rows)
    ref = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY).restore_planned(
        6, *jtrees[:2], shard_slices=rows)
    assert got[0]["embed"].shape[0] == 5
    _assert_same_trees(got, ref)
    with pytest.raises(ValueError, match="shape"):
        ck.restore_planned(6, {**tp, "final_norm": torch.zeros(3)},
                           ttrees[1])


# ---------------------------------------------------------- train loop ---

def _run(m, tp, ck=None, **kw):
    logs = []
    params, opt, hist = train_loop(
        m, batch=B, seq_len=S, log_every=1, log_fn=logs.append,
        params=None if tp is None else tree_map(torch.clone, tp),
        checkpointer=ck, **kw)
    return params, opt, [h["loss"] for h in hist]


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full_every", [0, 3])
def test_resume_equals_the_uninterrupted_run(tmp_path, jax_rules, dtype,
                                             full_every):
    """6 steps == 3 steps, saves, a fresh model resuming from step 3 for 3
    more: params, AdamW state and every loss bit for bit (fp32 and bf16
    compute over fp32 masters; with full_every the run saves every step
    and step 3 is the end of a full + delta + delta chain)."""
    _, _, m, tp = _pair(jax_rules, dtype)
    params_a, opt_a, losses_a = _run(m, tp, steps=6)
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    _, _, losses_b = _run(m, tp, ck, steps=3,
                          ckpt_every=1 if full_every else 3,
                          full_every=full_every)
    assert ck.latest_step() == 3
    assert ck.load_index(3).is_delta == bool(full_every)
    fresh = Model(m.cfg, device="cpu")
    params_b, opt_b, rest = _run(fresh, None, ck, steps=3, resume_from=3)
    assert losses_b[:3] + rest == losses_a
    _assert_bitwise(params_b, params_a)
    _assert_bitwise(opt_b, opt_a)
    assert int(opt_b["step"]) == 6


def test_resume_from_needs_a_checkpointer(fp32_pair):
    _, _, m, _ = fp32_pair
    with pytest.raises(ValueError, match="resume_from"):
        train_loop(m, batch=1, seq_len=8, steps=1, resume_from=3)


def test_port_continues_a_jax_training_checkpoint(tmp_path, jax_rules):
    """The reference trains 3 steps and saves; each package resumes from
    that checkpoint for 3 steps: the same losses to 2e-4."""
    jm, jp, m, _ = _pair(jax_rules, "float32")
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    jtrain_loop(jm, batch=B, seq_len=S, steps=3, log_fn=lambda _: None,
                params=jax.tree.map(jnp.copy, jp), checkpointer=jck,
                ckpt_every=3)
    assert jck.latest_step() == 3
    _, _, jhist = jtrain_loop(jm, batch=B, seq_len=S, steps=3, log_every=1,
                              log_fn=lambda _: None, checkpointer=jck,
                              resume_from=3)
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    _, opt, losses = _run(m, None, ck, steps=3, resume_from=3)
    np.testing.assert_allclose(losses, [h["loss"] for h in jhist],
                               rtol=FP32_TOL)
    assert int(opt["step"]) == 6


def test_train_cli_resumes_from_its_workdir(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    args = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq-len",
            "16", "--workdir", str(tmp_path), "--ckpt-every", "2",
            "--full-every", "2"]
    train_cli.main(args)
    first = capsys.readouterr().out
    assert "cold start" in first and "checkpoint @ step 4 (delta" in first
    train_cli.main(args)
    second = capsys.readouterr().out
    assert "resuming params/opt from step 4" in second
    assert "steps 4-7" in second


# ------------------------------------------------------------- serving ---

def test_from_checkpoint_greedy_tokens_match_the_reference(tmp_path,
                                                          fp32_pair):
    jm, jp, m, _ = fp32_pair
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    jck.save(0, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3)]
    jeng = JServeEngine.from_checkpoint(jm, jck, batch=3, cache_len=32)
    ref = jeng.generate([JRequest(prompt=p, max_new_tokens=6)
                         for p in prompts])
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    sched = IOScheduler()
    eng = ServeEngine.from_checkpoint(m, ck, batch=3, cache_len=32,
                                      sched=sched)
    got = eng.generate([Request(prompt=p, max_new_tokens=6) for p in prompts])
    assert [r.generated for r in got] == [r.generated for r in ref]
    dfs = sched.snapshot()["dfs"]["bytes"]
    assert dfs["critical"] > 0 and dfs["deferred"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_checkpoint_serves_the_saved_tensors(tmp_path, jax_rules, dtype):
    """An engine from a training checkpoint gives the same prefill logits,
    bit for bit, as one built from the saved tensors directly."""
    _, _, m, tp = _pair(jax_rules, dtype)
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(1, tp, adamw_init(tp))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (2, 7)).astype(np.int32))
    direct = ServeEngine(m, m.serving_params(tp), batch=2, cache_len=16,
                         device="cpu")
    restored = ServeEngine.from_checkpoint(m, ck, batch=2, cache_len=16)
    a, _ = direct._prefill(direct.params, {"tokens": toks},
                           unembed=direct.unembed)
    b, _ = restored._prefill(restored.params, {"tokens": toks},
                             unembed=restored.unembed)
    assert torch.equal(a, b)
    # tune_store: the engine carries the profile it fetched (none before a
    # publish); on the CPU the kernels take no launch config, so greedy
    # generation under it equals generation without it
    store = ProfileStore(HdfsFuseMount(HdfsCluster(tmp_path / "t")))
    assert ServeEngine.from_checkpoint(m, ck, batch=2, cache_len=16,
                                       tune_store=store).tune_profile is None
    prof = TuningProfile(backend="cpu")
    prof.record("ssd|s16|h4|p16|g1|n16|float32|cpu", {"chunk": 16})
    digest = store.publish(prof)["digest"]
    tuned = ServeEngine.from_checkpoint(m, ck, batch=2, cache_len=16,
                                        tune_store=store)
    assert tuned.tune_profile.digest() == digest
    assert tuned.tune_profile.store is store
    prompts = [toks[i, :5 + 2 * i].numpy() for i in range(2)]
    runs = [eng.generate([Request(prompt=p, max_new_tokens=4)
                          for p in prompts]) for eng in (tuned, restored)]
    assert [r.generated for r in runs[0]] == [r.generated for r in runs[1]]
    assert get_active_profile() is None
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_checkpoint(m, Checkpointer(
            HdfsCluster(tmp_path / "empty")), batch=2, cache_len=16)


def test_serve_cli_seeds_and_serves_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    args = ["--device", "cpu", "--arch", ARCH, "--requests", "2",
            "--new-tokens", "3", "--batch", "2", "--cache-len", "32",
            "--workdir", str(tmp_path)]
    serve_cli.main(args)
    first = capsys.readouterr().out
    serve_cli.main(args)
    second = capsys.readouterr().out
    assert "seeded checkpoint step 0" in first
    assert "seeded" not in second and "planned restore of step 0" in second
    assert "served 2 requests, 6 tokens" in second


# ------------------------------------------------- the I/O guardrail ---

@pytest.fixture
def io_witness(monkeypatch):
    """Bytes read through the port's ``HdfsCluster``, each attributed to
    the "dfs" slot its thread holds at the time (tests/torch_io_witness.py)."""
    return torch_io_witness.install(monkeypatch)


@pytest.mark.parametrize("async_tail", [False, True])
def test_scheduled_restore_reads_every_byte_in_a_slot(tmp_path, fp32_pair,
                                                      io_witness, async_tail):
    _, _, _, tp = fp32_pair
    trees = (tp, adamw_init(tp))
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(2, *trees)
    _, plans = ck.plan_restore(2, *trees)
    index_bytes = len(ck.hdfs.read(ck.index_path(2)))
    io_witness.read.clear()
    sched = IOScheduler()
    out = ck.restore_planned(2, *trees, sched=sched, async_tail=async_tail)
    if async_tail:
        out = (out[0], *out[1].result())
    _assert_bitwise(out[1], trees[1])
    # the async tail streams DEFERRED; a synchronous one gates the caller
    # and is read at the params' priority, as in the reference
    tail = plans[1].planned_bytes
    critical = index_bytes + plans[0].planned_bytes
    io_witness.check(critical=critical + (0 if async_tail else tail),
                     deferred=tail if async_tail else 0)
    assert sched.snapshot()["dfs"]["bytes"]["deferred"] == (
        tail if async_tail else 0)


def test_the_witness_catches_an_unscheduled_read(tmp_path, fp32_pair,
                                                 io_witness):
    """A read planted outside any slot makes the check fail."""
    _, _, _, tp = fp32_pair
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), striped=False)
    ck.save(1, tp)
    io_witness.read.clear()
    ck.restore_planned(1, tp, sched=IOScheduler())
    planned = io_witness.read[CRITICAL]
    ck.hdfs.pread(ck.data_path(1), 0, 64)
    with pytest.raises(AssertionError, match="outside any dfs slot"):
        io_witness.check(critical=planned, deferred=0)


def test_lint_finds_nothing_new_in_the_port():
    """The port's lock-order and I/O-discipline lint over the port: its
    findings are exactly its reviewed, suppressed ones
    (analysis_baseline_torch.json, the copies of the reference's
    analysis_baseline.json): the plain reader's ``priority``, accepted
    for signature parity and not forwarded (a plain file is read whole
    under the caller's slot), and three intentional singleflights that
    block same-key callers under a per-key lock."""
    from repro_torch.analysis.cli import run_analysis
    report = run_analysis(
        baseline_path=ROOT / "analysis_baseline_torch.json")
    assert report.new == [] and report.stale == []
    reviewed = json.loads(
        (ROOT / "analysis_baseline.json").read_text())["suppressions"]
    assert {(f.check, f.function, f.detail) for f in report.findings} == {
        (r["check"], r["function"].replace("repro.", "repro_torch.", 1),
         r["detail"]) for r in reviewed}
