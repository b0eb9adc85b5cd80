"""Four gloo ranks on the CPU: tiny fp32 moonshot-v1-16b-a3b under
``"tp"`` and ``"ep"`` on (2, 2) and (1, 4) meshes (and ``"tp"`` on (2, 2)
in the serving layout, the hidden dim over both axes) against the JAX
reference on the same mesh shape and weights
(``tests/torch_sharding_harness.py``): prefill logits, 4 greedy decodes,
the loss and the aux, every gradient leaf (gathered) and one AdamW step,
to 2e-4. Inside the MoE island capacity counts the data shard's tokens
and the aux is the mean of the shards' auxes, so with a data axis larger
than 1 the result is the reference's on that mesh, not the one-device
one."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_sharding_harness as H

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

TOL = 2e-4
ARCH = "moonshot-v1-16b-a3b"
CASES = [dict(arch=ARCH, mesh=m, rules={"moe_sharding": s})
         for s in ("tp", "ep") for m in ((2, 2), (1, 4))] + [
    dict(arch=ARCH, mesh=(2, 2), rules={"moe_sharding": "tp",
                                        "serving_layout": True})]
IDS = [f"{c['rules']['moe_sharding']}-{c['mesh'][0]}x{c['mesh'][1]}" +
       ("-serving" if c["rules"].get("serving_layout") else "")
       for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.rehearse(CASES, tmp_path_factory.mktemp("shard_moe"))


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


def test_a_data_axis_gives_per_shard_capacity_and_aux(runs):
    """The one-device port on the same weights: (1, 4) is its result (one
    data shard), (2, 2) is not (each data shard routes its own tokens at
    its own capacity, and the aux is the shards' mean), and is the
    reference's on (2, 2) (above)."""
    case, _, _ = runs[0]
    cfg = reduced(get_config(ARCH), dtype="float32")
    model = Model(cfg, device="cpu")
    params = params_from_numpy(case["params"], cfg, device="cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        logits, _ = model.prefill(
            params, {"tokens": torch.from_numpy(case["tokens"])},
            cache_len=case["cache_len"])
        _, metrics = model.train_loss(params, {
            "tokens": torch.from_numpy(case["train_tokens"]),
            "labels": torch.from_numpy(case["train_labels"])})
    one = {"prefill": logits.numpy(), "aux": metrics["aux"].numpy()}
    by_mesh = {(c["rules"]["moe_sharding"], c["mesh"]): port
               for c, _, port in runs if len(c["rules"]) == 1}
    for sharding in ("tp", "ep"):
        flat = by_mesh[sharding, (1, 4)]
        split = by_mesh[sharding, (2, 2)]
        for what in ("prefill", "aux"):
            assert H.worst(flat[what], one[what]) <= TOL
        assert H.worst(split["aux"], one["aux"]) > 1e-3
        assert not np.allclose(split["prefill"], one["prefill"], atol=1e-2)
