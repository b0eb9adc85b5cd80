"""``Checkpointer.restore_bytes_for_shard`` in the port against the JAX
package's, on the same saved checkpoint: the bytes a host plans to read
when it takes ``fraction`` of every sharded entry and the rest whole.
Both packages write the same files (tests/test_torch_ckpt.py), so the port
saves and both read. The cases are the reference test's
(``tests/test_ckpt_delta.py``: row shards by ``shard_slices``, and no
sharding information, a scalar read whole) and tiny qwen2.5-3b's
parameters and AdamW state with ``specs`` and ``rules`` (the reference's
on an Auto-axis (1, 1) mesh) or ``axis_sizes``. Integers, compared
exactly."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.dfs.hdfs import HdfsCluster as JHdfs
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules as jmake_rules
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.sharding.rules import single_device_rules

ARCH = "qwen2.5-3b"
GEOMETRY = dict(width=2, chunk=4096, stripe=16384)


def _port(tmp_path):
    return Checkpointer(HdfsCluster(tmp_path / "h"), **GEOMETRY)


def _ref(tmp_path):
    """The JAX Checkpointer over the same directory, opened after the
    port's saves (its DFS reads the directory when it is made)."""
    return JCheckpointer(JHdfs(tmp_path / "h"), **GEOMETRY)


@pytest.mark.parametrize("fraction", [0.25, 0.5])
def test_row_shards_and_no_information(tmp_path, fraction):
    """The reference test's cases: w sharded by rows, b replicated and read
    whole; with no information every non-scalar entry at ``fraction``, a
    scalar whole."""
    ck = _port(tmp_path)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ck.save(5, {"w": w, "b": b})
    ck.save(6, {"w": w, "n": torch.tensor(7, dtype=torch.int32)})
    jck = _ref(tmp_path)
    rows = {"t0['w']": (0, 16)}
    got = ck.restore_bytes_for_shard(5, fraction, shard_slices=rows)
    assert got == jck.restore_bytes_for_shard(5, fraction,
                                              shard_slices=rows)
    assert got == int(w.numel() * 4 * fraction + b.numel() * 4)
    got = ck.restore_bytes_for_shard(6, fraction)
    assert got == jck.restore_bytes_for_shard(6, fraction)
    assert got == int(w.numel() * 4 * fraction + 4)


@pytest.fixture(scope="module")
def model_ckpt(tmp_path_factory):
    """Tiny qwen2.5-3b's fp32 params and AdamW state saved by the port at
    step 4; the specs of the params in both packages' forms."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jrules = jmake_rules(mesh)
    jm = JModel(jreduced(jget_config(ARCH), dtype="float32"), jrules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    path = tmp_path_factory.mktemp("shard_bytes")
    ck = _port(path)
    ck.save(4, tp, adamw_init(tp))
    jck = _ref(path)
    port_specs = Model(cfg, device="cpu").param_specs()
    return ck, jck, jrules, jrules.param_specs(jm.cfg), port_specs, tp


@pytest.mark.parametrize("fraction", [0.125, 0.5])
def test_specs_with_rules(model_ckpt, fraction):
    """``specs`` (the params' specs as each package makes them) with
    ``rules``: every entry the specs name at ``fraction``, the optimizer
    state and the rest whole."""
    ck, jck, jrules, jspecs, specs, _ = model_ckpt
    got = ck.restore_bytes_for_shard(4, fraction, specs=(specs,),
                                     rules=single_device_rules())
    assert got == jck.restore_bytes_for_shard(4, fraction, specs=(jspecs,),
                                              rules=jrules)
    whole = ck.restore_bytes_for_shard(4, 1.0)
    assert 0 < got < whole


def test_specs_with_axis_sizes(model_ckpt):
    """Every non-scalar parameter over ``data`` of 2, by ``axis_sizes``
    and ``coords``; and with no information at all."""
    ck, jck, _, _, _, tp = model_ckpt
    specs = tree_map(lambda t: ("data",) if t.dim() else None, tp)
    jspecs = tree_map(lambda t: PartitionSpec("data") if t.dim() else None,
                      tp)
    sharded = dict(axis_sizes={"data": 2}, coords={"data": 1})
    got = ck.restore_bytes_for_shard(4, 0.5, specs=(specs,), **sharded)
    assert got == jck.restore_bytes_for_shard(4, 0.5, specs=(jspecs,),
                                              **sharded)
    assert ck.restore_bytes_for_shard(4, 0.5) == \
        jck.restore_bytes_for_shard(4, 0.5)
