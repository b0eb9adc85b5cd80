"""Four gloo ranks on the CPU: tiny fp32 qwen2.5-3b on (2, 2) and (1, 4)
meshes, and on (2, 2) with the serving layout (parameters pure TP over
both axes, the ring over all of them) and with sequence-sharded
activations, against the JAX reference on the same mesh shape and weights
(``tests/torch_sharding_harness.py``): prefill logits, 4 greedy decodes,
the loss, every gradient leaf (gathered) and one AdamW step, to 2e-4; on
(2, 2) also ``Model.init`` on the mesh, the ``ShardedLoader``'s rows and
``ServeEngine``."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_sharding_harness as H

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_map
from repro_torch.serve.engine import Request, ServeEngine

TOL = 2e-4
CASES = [dict(arch="qwen2.5-3b", mesh=(2, 2), extras=True),
         dict(arch="qwen2.5-3b", mesh=(1, 4)),
         dict(arch="qwen2.5-3b", mesh=(2, 2), rules={"serving_layout": True}),
         dict(arch="qwen2.5-3b", mesh=(2, 2),
              rules={"seq_sharded_acts": True})]
IDS = [f"{c['arch']}-{c['mesh'][0]}x{c['mesh'][1]}" +
       "".join(f"-{k}" for k in c.get("rules", {})) for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.rehearse(CASES, tmp_path_factory.mktemp("shard_dense"))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
@pytest.mark.parametrize("what", ["prefill", "decodes", "decode_tokens",
                                  "loss", "ce", "aux"])
def test_outputs_match_the_reference_on_the_same_mesh(runs, i, what):
    _, ref, port = runs[i]
    assert H.worst(port[what], ref[what]) <= (0 if what == "decode_tokens"
                                              else TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
@pytest.mark.parametrize("what", ["grads", "stepped"])
def test_every_leaf_matches_the_reference(runs, i, what):
    _, ref, port = runs[i]
    errs = H.leaf_errors(port[what], ref[what])
    assert max(errs.values()) <= TOL, errs


def _plain(case):
    cfg = reduced(get_config(case["arch"]), dtype="float32")
    return cfg, Model(cfg, device="cpu")


def test_init_on_the_mesh_is_the_one_device_init(runs):
    """Each rank draws every part of every leaf in the one-device order
    and keeps its slice: gathered, the one-device weights bit for bit."""
    case, _, port = runs[0]
    _, model = _plain(case)
    want = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(3), dtype=torch.float32))
    assert H.worst(port["init"], want) == 0.0


def test_sharded_loader_rows_are_the_references_shards(runs):
    """Each rank's rows are the reference's ``ShardedLoader`` shard on the
    device at the same mesh coordinates."""
    _, ref, port = runs[0]
    assert sorted(port["rank_rows"]) == sorted(ref["loader_shards"])
    for coords, rows in port["rank_rows"].items():
        np.testing.assert_array_equal(rows, ref["loader_shards"][coords])


def test_serve_engine_on_the_mesh_is_the_one_device_engine(runs):
    """Greedy tokens from the sharded weights (logits gathered before
    sampling) are the one-device engine's."""
    case, ref, port = runs[0]
    cfg, model = _plain(case)
    params = params_from_numpy(ref["params"], cfg, device="cpu",
                               dtype=torch.float32)
    engine = ServeEngine(model, params, batch=4, cache_len=case["cache_len"],
                         device="cpu")
    reqs = [Request(prompt=case["tokens"][i], max_new_tokens=4)
            for i in range(4)]
    want = np.array([r.generated for r in engine.generate(reqs)])
    np.testing.assert_array_equal(port["engine"], want)
