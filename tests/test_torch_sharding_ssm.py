"""Four gloo ranks on the CPU: tiny fp32 mamba2-370m (SSM) and zamba2-1.2b
(hybrid: the shared block's gradient summed over its calls) on (2, 2) and
(1, 4) meshes against the JAX reference on the same mesh shape and weights
(``tests/torch_sharding_harness.py``): prefill logits, 4 greedy decodes,
the loss, every gradient leaf (gathered) and one AdamW step, to 2e-4. The
last case sets the reference's SSD knobs on both sides, bf16 intra-chunk
products at a chunk of 16 (``Rules(ssd_compute_dtype="bfloat16",
ssm_chunk=16)``), on each rank's heads. Its gradients differ from the
reference's by bf16 rounding (torch and XLA round the bf16 einsums'
transposes at other places; measured up to ~3e-3 of a leaf on one
device), which stays under 2e-4 in absolute terms; but AdamW's first step
moves each entry by lr g / (|g| + eps), ~lr sign(g), so an entry whose
gradient is near zero may step by up to 2 lr apart: its stepped params are
held to ``KNOB_STEP_TOL`` = 2 lr (measured 3.1e-4, one entry of
B_proj)."""

from __future__ import annotations

import pytest
import torch_sharding_harness as H

TOL = 2e-4
KNOBS = dict(ssd_compute_dtype="bfloat16", ssm_chunk=16)
KNOB_STEP_TOL = 2 * 3e-4    # AdamWConfig's lr
CASES = [dict(arch=a, mesh=m) for a in ("mamba2-370m", "zamba2-1.2b")
         for m in ((2, 2), (1, 4))]
CASES.append(dict(arch="mamba2-370m", mesh=(2, 2), rules=KNOBS))
IDS = [f"{c['arch']}-{c['mesh'][0]}x{c['mesh'][1]}"
       + ("-knobs" if "rules" in c else "") for c in CASES]


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
    case, ref, port = runs[i]
    errs = H.leaf_errors(port[what], ref[what])
    tol = KNOB_STEP_TOL if what == "stepped" and "rules" in case else TOL
    assert max(errs.values()) <= tol, errs
