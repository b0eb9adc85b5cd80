"""Sharded restore on four gloo ranks: each rank of a (2, 2) mesh plans
and reads only its slices of a checkpoint (``dim_slices_for_spec`` inside
the ``IOScheduler``'s slots, held by ``tests/torch_io_witness.py``) and
wraps them as DTensors with the parameters' placements, from a checkpoint
the port saved on the mesh (every rank gathers each leaf, rank 0 writes
it, one leaf whole at a time) and from one the JAX package saved."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch_sharding_harness as H

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.dfs.hdfs import HdfsCluster as JHdfs
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules as jmake_rules

ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_ckpt")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jmodel = JModel(jreduced(jget_config(ARCH), dtype="float32"),
                    jmake_rules(mesh))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5)))
    JCheckpointer(JHdfs(root / "hdfs"), **H.GEOMETRY).save(2, params)
    outs = H.run_ranks(H.restore_rank, [dict(
        arch=ARCH, mesh=(2, 2), root=str(root / "hdfs"), params=params,
        steps=(1, 2))], root)
    return params, [rank[0] for rank in outs]


def test_sharded_save_holds_one_gathered_leaf_at_a_time(restored):
    _, ranks = restored
    for out in ranks:
        save = out["save"]
        assert 0 < save["peak"] <= save["largest"] < save["tree"]


@pytest.mark.parametrize("step,who", [(1, "port"), (2, "reference")])
def test_each_rank_restores_its_slices(restored, step, who):
    params, ranks = restored
    for out in ranks:
        got = out[step]
        assert got["dtensors"]
        assert H.worst(got["params"], params) == 0.0
        # only this rank's slices are read, every byte inside a slot
        assert got["payload"] == got["mine"]
        assert got["read"] == got["index_bytes"] + got["planned"]
        assert got["unslotted"] == 0
    total = sum(np.asarray(v).nbytes for v in jax.tree.leaves(params))
    assert all(out[step]["payload"] < total for out in ranks)
    # the ranks' slices cover every byte (replicated leaves on each rank)
    assert sum(out[step]["payload"] for out in ranks) >= total
