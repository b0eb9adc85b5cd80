"""Four gloo ranks on the CPU: tiny fp32 mamba2-370m (SSM) and zamba2-1.2b
(hybrid: the shared block's gradient summed over its calls) on (2, 2) and
(1, 4) meshes against the JAX reference on the same mesh shape and weights
(``tests/torch_sharding_harness.py``): prefill logits, 4 greedy decodes,
the loss, every gradient leaf (gathered) and one AdamW step, to 2e-4."""

from __future__ import annotations

import pytest
import torch_sharding_harness as H

TOL = 2e-4
CASES = [dict(arch=a, mesh=m) for a in ("mamba2-370m", "zamba2-1.2b")
         for m in ((2, 2), (1, 4))]
IDS = [f"{c['arch']}-{c['mesh'][0]}x{c['mesh'][1]}" for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.rehearse(CASES, tmp_path_factory.mktemp("shard_ssm"))


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
