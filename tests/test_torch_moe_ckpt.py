"""The MoE family's schema, initialisation, checkpoints and launchers:
moonshot-v1-16b-a3b's full-width schema on the meta device against the
reference's parameter count; ``Model.init``'s layer-by-layer draw (the
schema's shapes, dtypes and distributions); the [L, E, D, F] expert leaves
and the router through ``ckpt/checkpoint.py`` in both packages (the same
files, each restoring the other's, ``ServeEngine.from_checkpoint``
serving them); and both launchers on tiny moonshot through the BootSeer
runtime, on the CPU.

The reference runs on an Auto-axis (1, 1) mesh, as in
tests/test_torch_hybrid_ckpt.py, whose helpers these tests share.
Restores and engines are compared bit for bit and token for token.
"""

import json

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
from repro_torch.configs.base import MoEConfig
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models import model as model_lib
from repro_torch.models.model import Model, param_schema
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_ckpt import (GEOMETRY, _assert_same_trees, _data, _manifest,
                             _trees)

ARCH = "moonshot-v1-16b-a3b"


def _mesh_rules():
    return make_rules(jax.make_mesh((1, 1), ("data", "model"),
                                    axis_types=(AxisType.Auto,) * 2))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port fp32 masters): tiny
    moonshot (4 experts, top 2), the same weights."""
    jm = JModel(jreduced(jget_config(ARCH), dtype="float32"), _mesh_rules())
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jm, jp, Model(cfg, device="cpu"), tp


# --------------------------------------------------------- the schema ---

def test_full_config_counts_the_references_parameters():
    """At full width on the meta device: 28.06 B parameters, the
    reference's ``count_params`` and ``cfg.param_count()``, each layer
    0.5706 B (its 64 experts 0.5536 B), 3.974 B active a token (6 of the
    64 experts, the embedding and head included); the experts' leaves
    stacked [L, E, D, F]; 48 rings of 16 heads of 128."""
    cfg = get_config(ARCH)
    m = Model(cfg, device="cpu")
    meta = m.init_like()
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(meta))
    n = sum(t.numel() for t in tree_leaves(meta))
    assert m.count_params() == n == cfg.param_count() == 28_057_995_264
    assert JModel(jget_config(ARCH), _mesh_rules()).count_params() == n
    shapes = {k: tuple(t.shape) for k, t in meta["layers"].items()}
    assert shapes["router"] == (48, 2048, 64)
    assert shapes["w_gate"] == shapes["w_up"] == (48, 64, 2048, 1408)
    assert shapes["w_down"] == (48, 64, 1408, 2048)
    per_layer = sum(t[0].numel() for t in meta["layers"].values())
    assert per_layer == 570_560_512
    assert cfg.active_param_count() == 3_974_301_696
    assert m.cache_shapes(8, 2048)["k"] == (48, 8, 2048, 16, 128)
    assert m._schedule(meta)[47][0] == "attn"
    assert len(m._schedule(meta)) == 48


def test_dense_config_with_moe_gets_the_expert_leaves():
    cfg = reduced(get_config("qwen2.5-3b"), moe=MoEConfig(4, 2))
    leaves = param_schema(cfg)["layers"]
    assert leaves["router"].shape == (2, 256, 4)
    assert leaves["w_down"].shape == (2, 4, 512, 256)
    assert "bq" in leaves             # qwen's qkv biases stay


# ------------------------------------------------------- the draw ---

@pytest.mark.parametrize("part", [None, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_draws_each_layer_apart_with_the_schema_distributions(
        monkeypatch, dtype, part):
    """``init`` makes each leaf in its own dtype and fills it in parts of
    its first dimension (one layer of a stacked leaf; with ``part`` = 4096
    elements, a few rows of every leaf): every leaf has the schema's shape
    and dtype, every normal leaf's mean is within 4 standard errors of 0
    and its std within 3% of the schema's, every layer of it with the same
    std and a different draw; ones are exact."""
    if part:
        monkeypatch.setattr(model_lib, "_INIT_PART", part)
    cfg = reduced(get_config(ARCH), num_layers=3, moe=MoEConfig(8, 2))
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0), dtype=dtype)
    schema = param_schema(cfg)
    seen = 0
    for part, sub in (("layers", schema["layers"]),
                      ("top", {k: v for k, v in schema.items()
                               if k != "layers"})):
        for name, leaf in sub.items():
            t = (p["layers"] if part == "layers" else p)[name]
            assert tuple(t.shape) == leaf.shape and t.dtype == dtype, name
            x = t.float()
            if leaf.init[0] == "ones":
                assert torch.all(x == 1), name
                continue
            std = leaf.init[1]
            layers = list(x) if part == "layers" else [x]
            for i, xi in enumerate(layers):
                assert abs(xi.mean().item()) < 4 * std / xi.numel() ** 0.5, \
                    (name, i)
                assert abs(xi.std().item() / std - 1) < 3e-2, (name, i)
            if part == "layers":
                assert not torch.equal(layers[0], layers[1]), name
            seen += 1
    assert seen == 10                 # embed, lm_head, and 8 stacked
    again = m.init(torch.Generator().manual_seed(0), dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))


# -------------------------------------------------------- checkpoints ---

def test_entry_names_hold_the_expert_leaves(pair):
    _, jp, _, tp = pair
    jtrees, ttrees = _trees(jp, tp)
    _assert_same_trees(ttrees, jtrees)
    names = [n for n, _ in flat_with_names(ttrees[1])]
    assert "['mu']['layers']['router']" in names
    assert "['nu']['layers']['w_down']" in names
    shapes = {n: tuple(t.shape) for n, t in flat_with_names(tp)}
    assert shapes["['layers']['w_gate']"] == (2, 4, 256, 512)
    assert shapes["['layers']['router']"] == (2, 256, 4)


@pytest.mark.parametrize("striped", [True, False])
def test_both_packages_write_the_same_files(tmp_path, pair, striped):
    """The same manifests, data streams and index files for params, AdamW
    state and a bf16 copy, the [L, E, D, F] leaves among them."""
    _, jp, _, tp = pair
    jtrees, ttrees = _trees(jp, tp)
    jh, th = JHdfs(tmp_path / "j"), HdfsCluster(tmp_path / "t")
    jck = JCheckpointer(jh, striped=striped, **GEOMETRY)
    ck = Checkpointer(th, striped=striped, **GEOMETRY)
    jidx, idx = jck.save(4, *jtrees), ck.save(4, *ttrees)
    assert _manifest(idx) == _manifest(jidx)
    assert any("['w_gate']" in e.name and len(e.shape) == 4
               for e in idx.entries.values())
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
    (params,) = Checkpointer(HdfsCluster(tmp_path / "a"), **GEOMETRY) \
        .restore_planned(1, m.init_like(dtype=torch.float32))
    _assert_same_trees([params], [jtrees[0]])
    assert params["layers"]["w_up"].shape == (2, 4, 256, 512)

    Checkpointer(HdfsCluster(tmp_path / "b"), **GEOMETRY).save(2, *ttrees)
    back = JCheckpointer(JHdfs(tmp_path / "b"), **GEOMETRY).restore_planned(
        2, *jtrees)
    _assert_same_trees(ttrees, back)


def test_from_checkpoint_greedy_tokens_match_the_reference(tmp_path, pair):
    """The reference's engine over its own checkpoint and the port's
    engine over the same files: the same greedy tokens (fp32; capacity
    counts the engine's left padding in both)."""
    jm, jp, m, _ = pair
    jck = JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)
    jck.save(0, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
               for n in (30, 45, 38)]
    ref = JServeEngine.from_checkpoint(jm, jck, batch=3, cache_len=64) \
        .generate([JRequest(prompt=p, max_new_tokens=6) for p in prompts])
    eng = ServeEngine.from_checkpoint(
        m, Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY), batch=3,
        cache_len=64)
    got = eng.generate([Request(prompt=p, max_new_tokens=6) for p in prompts])
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert all(len(r.generated) == 6 for r in got)


# ---------------------------------------------------------- launchers ---

def test_train_cli_loss_falls_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                    "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and "moonshot-v1-16b-a3b-tiny" in done[0]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert last < first


def test_serve_cli_boots_twice_with_the_same_greedy_tokens(tmp_path, capsys):
    """Cold, then warm through the runtime from the same workdir: the
    checkpoint (its expert leaves among them) seeded once, the same greedy
    tokens both times."""
    args = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
            "--new-tokens", "4", "--batch", "2", "--cache-len", "96",
            "--workdir", str(tmp_path)]
    runs = []
    for _ in range(2):
        serve_cli.main(args)
        runs.append(capsys.readouterr().out)
    assert "seeded checkpoint step 0" in runs[0] and "(cold)" in runs[0]
    assert "seeded" not in runs[1] and "(warm)" in runs[1]
    assert all("moonshot-v1-16b-a3b-tiny" in out for out in runs)
    ends = [json.loads(next(line for line in out.splitlines()
                            if line.startswith("boot-end: "))[10:])
            for out in runs]
    tokens = [end["greedy_tokens"] for end in ends]
    assert tokens[0] == tokens[1] and len(tokens[0]) == 2
    assert all(len(t) == 4 for t in tokens[0])
