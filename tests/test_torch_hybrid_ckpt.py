"""Checkpoints of the hybrid family's tree (tiny zamba2-1.2b, five layers:
the stacked Mamba2 leaves and the unstacked ``shared_attn`` block) across
the two packages: the same entry names, manifests and bytes for params and
AdamW state, each package restoring the other's files, and
``ServeEngine.from_checkpoint`` serving a hybrid checkpoint, on the CPU.

The reference runs on an Auto-axis (1, 1) mesh, as in
tests/test_torch_ckpt.py, whose helpers these tests share. Restores and
engines are compared bit for bit and token for token.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.dfs.hdfs import HdfsCluster as JHdfs
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import make_rules
from repro_torch.ckpt.checkpoint import Checkpointer, flat_with_names
from repro_torch.configs import get_config, reduced
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_ckpt import (GEOMETRY, _assert_same_trees, _data, _manifest,
                             _trees)

ARCH = "zamba2-1.2b"
LAYERS = 5


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port fp32 masters): the same
    weights, carried across as numpy."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jm = JModel(jreduced(jget_config(ARCH), dtype="float32",
                         num_layers=LAYERS), make_rules(mesh))
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype="float32", num_layers=LAYERS)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jm, jp, Model(cfg, device="cpu"), tp


def test_entry_names_hold_the_shared_block(pair):
    """params, AdamW's mu / nu / step and a bf16 copy: every entry under
    the reference's keystr, the shared block's unstacked."""
    _, jp, _, tp = pair
    jtrees, ttrees = _trees(jp, tp)
    _assert_same_trees(ttrees, jtrees)
    names = [n for n, _ in flat_with_names(ttrees[1])]
    assert "['mu']['shared_attn']['wo']" in names
    assert "['nu']['layers']['out_proj']" in names
    shapes = {n: tuple(t.shape) for n, t in flat_with_names(tp)}
    assert shapes["['shared_attn']['wq']"] == (256, 256)
    assert shapes["['layers']['A_log']"] == (LAYERS, 16)


@pytest.mark.parametrize("striped", [True, False])
def test_both_packages_write_the_same_files(tmp_path, pair, striped):
    """The same manifests (names, dtypes, shapes, offsets, chunk CRCs), data
    streams and index files for params, AdamW state and a bf16 copy."""
    _, jp, _, tp = pair
    jtrees, ttrees = _trees(jp, tp)
    jh, th = JHdfs(tmp_path / "j"), HdfsCluster(tmp_path / "t")
    jck = JCheckpointer(jh, striped=striped, **GEOMETRY)
    ck = Checkpointer(th, striped=striped, **GEOMETRY)
    jidx, idx = jck.save(4, *jtrees), ck.save(4, *ttrees)
    assert _manifest(idx) == _manifest(jidx)
    assert any("['shared_attn']" in e.name for e in idx.entries.values())
    assert idx.to_json() == jidx.to_json()
    assert _data(th, ck.data_path(4)) == _data(jh, jck.data_path(4))
    assert jh.read(jck.index_path(4)) == th.read(ck.index_path(4))


def test_each_package_restores_the_others(tmp_path, pair):
    _, jp, m, tp = pair
    jtrees, ttrees = _trees(jp, tp)
    JCheckpointer(JHdfs(tmp_path / "a"), **GEOMETRY).save(1, *jtrees)
    got = Checkpointer(HdfsCluster(tmp_path / "a"), **GEOMETRY) \
        .restore_planned(1, *ttrees)
    _assert_same_trees(got, jtrees)
    assert got[0]["shared_attn"]["wo"].dtype == torch.float32
    # into the model's own meta tree, as a resume asks for it
    (params,) = Checkpointer(HdfsCluster(tmp_path / "a"), **GEOMETRY) \
        .restore_planned(1, m.init_like(dtype=torch.float32))
    _assert_same_trees([params], [jtrees[0]])

    Checkpointer(HdfsCluster(tmp_path / "b"), **GEOMETRY).save(2, *ttrees)
    back = JCheckpointer(JHdfs(tmp_path / "b"), **GEOMETRY).restore_planned(
        2, *jtrees)
    _assert_same_trees(ttrees, back)


def test_from_checkpoint_serves_the_saved_tensors(tmp_path, pair):
    """An engine from a training checkpoint (params and AdamW state) gives
    the same greedy tokens, and bit-equal prefill logits, as one built
    from the saved tensors directly; prompts of 70-90 tokens pass the
    window of 64."""
    _, _, m, tp = pair
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)
    ck.save(1, tp, adamw_init(tp))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
               for n in (70, 90)]
    direct = ServeEngine(m, m.serving_params(tp), batch=2, cache_len=96,
                         device="cpu")
    restored = ServeEngine.from_checkpoint(m, ck, batch=2, cache_len=96)
    toks = torch.from_numpy(np.stack([prompts[1], prompts[1]]))
    a, _ = direct._prefill(direct.params, {"tokens": toks},
                           unembed=direct.unembed)
    b, _ = restored._prefill(restored.params, {"tokens": toks},
                             unembed=restored.unembed)
    assert torch.equal(a, b)
    outs = [eng.generate([Request(prompt=p, max_new_tokens=5)
                          for p in prompts]) for eng in (direct, restored)]
    assert [r.generated for r in outs[0]] == [r.generated for r in outs[1]]
    assert all(len(r.generated) == 5 for r in outs[1])


def test_from_checkpoint_greedy_tokens_match_the_reference(tmp_path, pair):
    """The reference's engine over its own checkpoint and the port's
    engine over the same files: the same greedy tokens."""
    jm, jp, m, _ = pair
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    jck.save(0, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
               for n in (66, 80, 75)]
    ref = JServeEngine.from_checkpoint(jm, jck, batch=3, cache_len=96) \
        .generate([JRequest(prompt=p, max_new_tokens=6) for p in prompts])
    eng = ServeEngine.from_checkpoint(
        m, Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY), batch=3,
        cache_len=96)
    got = eng.generate([Request(prompt=p, max_new_tokens=6) for p in prompts])
    assert [r.generated for r in got] == [r.generated for r in ref]
