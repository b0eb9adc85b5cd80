"""The reference's SSD numerics knobs on tiny zamba2-1.2b: the cases of
tests/test_torch_ssd_knobs.py (every ``ssd_compute_dtype`` and
``ssm_chunk`` in fp32 and bf16, prefill logits, three decodes,
``train_loss`` and every gradient leaf against the JAX package's ``Model``,
and the knob moving both packages' logits), at its tolerances; the shared
attention block runs once, over a window of 64 that the prompts of 100
pass. A file of its own, so that the two families run side by side."""

import pytest

from test_torch_ssd_knobs import (KNOBS, check_knob_moves, check_knobs,
                                  draw_weights, jax_mesh)  # noqa: F401

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def weights(jax_mesh):  # noqa: F811
    return draw_weights(ARCH, jax_mesh)


@pytest.mark.parametrize("cd,chunk", KNOBS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knobs_match_the_reference(jax_mesh, weights, dtype, cd,  # noqa: F811
                                   chunk):
    check_knobs(jax_mesh, weights, ARCH, dtype, cd, chunk)


def test_bf16_compute_moves_both_packages(jax_mesh, weights):  # noqa: F811
    check_knob_moves(jax_mesh, weights, ARCH)
