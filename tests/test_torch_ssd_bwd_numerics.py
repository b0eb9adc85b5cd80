"""The SSD backward kernel's numerics, emulated on the CPU: its algorithm
(``kernels/ref.py::ssd_backward_tiles``: the two walks over the tiles, G
once per group, dB / dC summed over a group's heads in head order) with
every fp32 operand of a tensor-core product rounded to its bf16 hi + lo
parts, as ``csrc/ssd_bwd.cu`` rounds them (``split=True``), against
``jax.grad`` of the JAX model's ``ssd_chunked`` and against the card's
gate.

Tolerances: against ``jax.grad`` in fp32 to 2e-4 of each output's largest
entry, as tests/test_torch_train_ssm.py holds the fp32 algorithm (each
split product errs ~2^-16 relative per term; measured: at most 2e-5).
Against the plain version (autograd of the chunked scan) from bf16 inputs,
with dx / dB / dC rounded to bf16 as the kernel writes them: the worst row
within half chip_smoke.py's gate (GRAD_ROW_RTOL 2e-2, rows floored at
GRAD_ROW_FLOOR of the median); measured 2.3e-3 (dx, dB, dC) and at most
3.4e-5 (ddt, dA), the same as the fp32 algorithm's.

Why the splits. One bf16 rounding of an operand (its lo part dropped, the
others split), measured at B = 2, S = 256, H = 4, P = 64, N = 128 (N = 64
in brackets), worst row against the plain version:

  operand            JAX tests' dt                  the model's dt / A
  M                  dx 7.7e-2 (4.9e-2)             dx 4.7e-3 (2.5e-3)
  Q                  dC 2.7e-2 (5.4e-2), dB 2.2e-2  dC 7.2e-3 (1.4e-2)
  S_in               dC 4.2e-3, ddt 2.5e-3 (9.9e-3) dC 3.6e-3 (5.0e-3)
  dS_out             dx 4.5e-3, ddt 3.6e-3          ddt 3.6e-3 (3.9e-3)
  x w (forward walk) dC 3.3e-3, ddt 3.0e-3          dC 4.0e-3 (7.4e-3)
  dy exp(cs)         dB 3.9e-3, ddt 2.2e-3          ddt 9.4e-3 (4.2e-3)

M and Q alone pass the 2e-2 gate with one rounding (under the JAX tests'
dt ~ 1, where the tile's own term carries dx, dB and dC); the others cost
a factor of 1.5-4 in ddt, dB or dC, inside the gate but no longer with
half of it to spare.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import (SPLIT_OPERANDS, row_rel_err,
                                     ssd_backward_reference,
                                     ssd_backward_tiles, split_bf16)
from test_torch_ssm import GRID
from test_torch_train import _close_leaf
from test_torch_train_ssm import (FP32_TOL, GRAD_NAMES, GRAD_ROW_FLOOR,
                                  GRAD_ROW_RTOL, _case, _jax_ssd_grads)

# mamba2-370m's head and state sizes, and zamba2-1.2b's state of 64, over
# eight tiles
GATE_SHAPES = [(2, 256, 4, 64, 1, 128), (2, 256, 4, 64, 2, 64)]


def _gate_errs(shape, dist, **kw):
    """Worst-row errors of the emulation's six gradients against the plain
    version, from bf16 inputs, dx / dB / dC rounded to bf16."""
    arrays, dy = _case(*shape, seed=21, dist=dist)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrays)
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    dy = torch.from_numpy(dy).bfloat16()
    got = list(ssd_backward_tiles(x, dt, A, Bm, Cm, D, dy, **kw))
    for i in (0, 3, 4):
        got[i] = got[i].bfloat16()
    ref = ssd_backward_reference(x, dt, A, Bm, Cm, D, dy, chunk=256)
    return {name: row_rel_err(t, r, floor=GRAD_ROW_FLOOR)
            for name, t, r in zip(GRAD_NAMES, got, ref)}


def test_split_bf16_parts():
    """hi + lo carries ~16 bits of an fp32 value, hi alone ~8."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    two = ((split_bf16(v) - v).abs() / v.abs()).max().item()
    one = ((split_bf16(v, 1) - v).abs() / v.abs()).max().item()
    assert two <= 2.0 ** -16 < one <= 2.0 ** -8


@pytest.mark.parametrize("dist", ["jax", "model"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_split_emulation_matches_jax(b, s, h, p, g, n, chunk, dist):
    """The kernel's algorithm with its hi / lo roundings against jax.grad,
    every input's gradient, in fp32."""
    arrays, dy = _case(b, s, h, p, g, n, seed=s + h, dist=dist)
    jg = _jax_ssd_grads(arrays, dy, chunk)
    got = ssd_backward_tiles(*(torch.from_numpy(a) for a in arrays),
                             torch.from_numpy(dy), split=True)
    for name, j, t in zip(GRAD_NAMES, jg, got):
        assert t.shape == np.shape(j) and t.dtype == torch.float32
        _close_leaf(name, j, t, FP32_TOL)


@pytest.mark.parametrize("dist", ["jax", "model"])
@pytest.mark.parametrize("shape", GATE_SHAPES, ids=["n128", "n64"])
def test_split_emulation_within_half_the_gate(shape, dist):
    """From bf16 inputs to bf16 dx / dB / dC, as on the card: every
    gradient within half the card's gate of the plain version."""
    errs = _gate_errs(shape, dist, split=True)
    assert all(e <= GRAD_ROW_RTOL / 2 for e in errs.values()), errs


@pytest.mark.parametrize("operand,grad", [("m", "dx"), ("q", "dC")])
def test_one_rounding_of_m_or_q_fails_the_gate(operand, grad):
    """M's and Q's lo parts are needed: without one, under the JAX tests'
    dt, the product it feeds moves past the card's gate."""
    errs = _gate_errs(GATE_SHAPES[0], "jax", split=True, hi_only=(operand,))
    assert errs[grad] > GRAD_ROW_RTOL, errs


def test_hi_only_names_split_operands():
    arrays, dy = _case(1, 32, 2, 32, 1, 16, seed=0)
    args = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(dy)]
    assert set(SPLIT_OPERANDS) == {"xw", "dye", "s_in", "ds_out", "m", "q"}
    with pytest.raises(ValueError, match="hi_only"):
        ssd_backward_tiles(*args, split=True, hi_only=("state",))
    with pytest.raises(ValueError, match="hi_only"):
        ssd_backward_tiles(*args, hi_only=("m",))
