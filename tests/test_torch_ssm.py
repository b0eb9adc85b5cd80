"""The port's Mamba2 SSD functions (``repro_torch.models.ssm``) and its
``ssd_op`` on the CPU against the JAX package's: the pure-jnp
``models/ssm.py`` and the Pallas kernel ``ssd_chunked_kernel`` run in
interpret mode, as the JAX package's own tests run it.

Inputs are made from a seed with numpy, in the distributions of
``tests/test_kernels.py``. Tolerance: fp32 to 2e-4 (an SSD output of order
1 summed in another order; measured ~1e-6).

The CUDA SSD kernel (``csrc/ssd.cu``) cannot run here; its error budget
can. ``_emulate_ssd_kernel`` repeats its rounding in torch: tiles of TILE,
bf16 tensor-core products summed in fp32, each fp32 operand (M, the state,
x w) split into bf16 hi + lo, and its cumulative-sum order. It is held
against the Pallas kernel by the card's gates (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ssd import ssd_chunked_kernel as jssd_kernel
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (row_rel_err, ssd_chunked_reference,
                                     ssd_reference)
from repro_torch.kernels.ssd import TILE
from repro_torch.models import ssm

FP32_TOL = 2e-4
# chip_smoke.py's gates for the SSD kernel against its plain version
SSD_Y_ROW_RTOL = 1e-2
SSD_STATE_ROW_RTOL = 1e-3

# (B, S, H, P, G, N, chunk): tests/test_kernels.py's grid
GRID = [
    (2, 128, 4, 32, 1, 16, 32),
    (1, 64, 2, 64, 1, 64, 32),     # state 64 (zamba2-like)
    (1, 128, 4, 64, 1, 128, 64),   # state 128 (mamba2-370m-like)
    (1, 96, 4, 32, 2, 16, 32),     # grouped B/C
    (1, 100, 2, 32, 1, 16, 32),    # padding path
]


def _inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.uniform(0.0, 1.0, h))).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return x, dt, A, B, C, D


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(j, t, tol=FP32_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_ssd_chunked_matches_reference(b, s, h, p, g, n, chunk):
    jargs, targs = _both(_inputs(b, s, h, p, g, n, seed=s + h))
    jy, jst = jssm.ssd_chunked(*jargs, chunk=chunk, return_state=True)
    ty, tst = ssm.ssd_chunked(*targs, chunk=chunk, return_state=True)
    assert ty.shape == (b, s, h, p) and tst.shape == (b, h, p, n)
    assert tst.dtype == torch.float32
    _close(jy, ty)
    _close(jst, tst)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_ssd_reference_matches_reference(b, s, h, p, g, n, chunk):
    jargs, targs = _both(_inputs(b, s, h, p, g, n, seed=s + h))
    jy, jst = jssm.ssd_reference(*jargs)
    ty, tst = ssd_reference(*targs)
    _close(jy, ty)
    _close(jst, tst)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_ssd_op_on_cpu_matches_the_pallas_kernel(b, s, h, p, g, n, chunk):
    """The port's CPU path against the JAX Pallas kernel in interpret
    mode, called directly and through the JAX package's ``ssd_op``."""
    jargs, targs = _both(_inputs(b, s, h, p, g, n, seed=s + h))
    ty, tst = ops.ssd_op(*targs, chunk=chunk)
    for jy, jst in (jssd_kernel(*jargs, chunk=chunk, interpret=True),
                    jops.ssd_op(*jargs, chunk=chunk, interpret=True)):
        _close(jy, ty)
        _close(jst, tst)


def test_ssd_op_on_cpu_is_the_plain_version():
    targs = _both(_inputs(1, 70, 2, 32, 1, 16, seed=5))[1]
    ty, tst = ops.ssd_op(*targs, chunk=32)
    ry, rst = ssd_chunked_reference(*targs, chunk=32)
    assert torch.equal(ty, ry) and torch.equal(tst, rst)


def test_chunk_invariance():
    targs = _both(_inputs(1, 128, 2, 32, 1, 16))[1]
    y32, st32 = ssm.ssd_chunked(*targs, chunk=32, return_state=True)
    y64, st64 = ssm.ssd_chunked(*targs, chunk=64, return_state=True)
    torch.testing.assert_close(y32, y64, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(st32, st64, atol=FP32_TOL, rtol=FP32_TOL)


def test_ssd_chunked_from_an_initial_state():
    arrays = _inputs(2, 72, 4, 32, 2, 16, seed=3)
    init = np.random.default_rng(4).standard_normal(
        (2, 4, 32, 16)).astype(np.float32)
    jargs, targs = _both(arrays)
    jy, jst = jssm.ssd_chunked(*jargs, chunk=32, return_state=True,
                               init_state=jnp.asarray(init))
    ty, tst = ssm.ssd_chunked(*targs, chunk=32, return_state=True,
                              init_state=torch.from_numpy(init))
    _close(jy, ty)
    _close(jst, tst)
    # a prompt split in two: the state handed over carries the first half
    first = [t[:, :40] for t in targs[:2]] + [targs[2]] + \
        [t[:, :40] for t in targs[3:5]] + [targs[5]]
    second = [t[:, 40:] for t in targs[:2]] + [targs[2]] + \
        [t[:, 40:] for t in targs[3:5]] + [targs[5]]
    y1, st1 = ssm.ssd_chunked(*first, chunk=32, return_state=True)
    y2, st2 = ssm.ssd_chunked(*second, chunk=32, return_state=True,
                              init_state=st1)
    whole, st = ssm.ssd_chunked(*targs, chunk=32, return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole,
                               atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(st2, st, atol=FP32_TOL, rtol=FP32_TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(6)
    b, h, p, g, n = 2, 4, 32, 2, 16
    arrays = [rng.standard_normal((b, h, p, n)).astype(np.float32),
              rng.standard_normal((b, h, p)).astype(np.float32),
              np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32),
              (-np.exp(rng.uniform(0, 1, h))).astype(np.float32),
              rng.standard_normal((b, g, n)).astype(np.float32),
              rng.standard_normal((b, g, n)).astype(np.float32),
              np.ones(h, np.float32)]
    jargs, targs = _both(arrays)
    jy, jst = jssm.ssd_decode_step(*jargs)
    ty, tst = ssm.ssd_decode_step(*targs)
    _close(jy, ty)
    _close(jst, tst)


def test_segsum_matches_reference():
    dA = -np.abs(np.random.default_rng(7).standard_normal((3, 2, 16))
                 ).astype(np.float32)
    j = np.asarray(jssm.segsum(jnp.asarray(dA)))
    t = ssm.segsum(torch.from_numpy(dA)).numpy()
    np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_prefill_then_decode_matches_reference(dtype):
    """causal_conv over a prompt (taps in the input dtype), then
    conv_decode_step token by token (fp32, rounded once) from its tail."""
    rng = np.random.default_rng(8)
    b, s, ch, width = 2, 9, 24, 4
    x = rng.standard_normal((b, s + 3, ch)).astype(np.float32)
    w = (rng.standard_normal((width, ch)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(ch) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    tol = FP32_TOL if dtype == "float32" else 2e-2
    jy, jtail = jssm.causal_conv(jx[:, :s], jnp.asarray(w), jnp.asarray(bias))
    ty, ttail = ssm.causal_conv(tx[:, :s], torch.from_numpy(w),
                                torch.from_numpy(bias))
    assert ty.dtype == tdt and ttail.dtype == tdt
    _close(jy, ty, tol)
    _close(jtail, ttail, 0)
    for t in range(s, s + 3):
        jy, jtail = jssm.conv_decode_step(jtail, jx[:, t], jnp.asarray(w),
                                          jnp.asarray(bias))
        ty, ttail = ssm.conv_decode_step(ttail, tx[:, t], torch.from_numpy(w),
                                         torch.from_numpy(bias))
        assert ty.dtype == tdt and ttail.dtype == tdt
        _close(jy, ty, tol)
        _close(jtail, ttail, 0)


def _bf16_parts(v: torch.Tensor, parts: int):
    """v as the kernel feeds it to a tensor core: hi = bf16(v), then, with
    two parts, lo = bf16(v - hi); products of the parts summed in fp32."""
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float())[:parts]


def _tile_cumsum(d: torch.Tensor) -> torch.Tensor:
    """The kernel's cumulative sum over the last axis (one tile, a
    position per lane of a warp): an inclusive Hillis-Steele scan,
    v_l = v_{l-k} + v_l for k = 1, 2, 4, 8, 16."""
    v = d
    for k in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :k], v[..., k:] + v[..., :-k]], dim=-1)
    return v


def _emulate_ssd_kernel(x, dt, A, B, C, D, *, m_parts=2, state_parts=2,
                        xw_parts=2):
    """csrc/ssd.cu's arithmetic in fp32 torch on the CPU, in tiles of
    TILE positions. x [b, s, h, p],
    dt [b, s, h], A/D [h], B/C [b, s, g, n], x/B/C holding bf16 values.
    ``*_parts`` split M, the state and x w as the kernel's kMParts,
    kStateParts and kXwParts do (2: hi + lo; 1: one bf16 rounding).
    Returns (y bf16 [b, s, h, p], state fp32 [b, h, p, n])."""
    b, s, h, p = x.shape
    n = B.shape[3]
    pad = -s % TILE

    def heads(t):  # [b, s, ...] -> [b, h, s + pad, ...] with zero padding
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.movedim(1, 2)

    rep = h // B.shape[2]
    xs, Bs, Cs = heads(x), heads(B.repeat_interleave(rep, 2)), heads(
        C.repeat_interleave(rep, 2))
    dts = heads(dt.unsqueeze(-1)).squeeze(-1)
    lower = torch.tril(torch.ones(TILE, TILE, dtype=torch.bool))
    state = torch.zeros(b, h, p, n)
    ys = []
    for t0 in range(0, s + pad, TILE):
        xt, Bt, Ct = (t[:, :, t0:t0 + TILE] for t in (xs, Bs, Cs))
        dtt = dts[:, :, t0:t0 + TILE]
        cs = _tile_cumsum(dtt * A[:, None])
        last = cs[..., -1:]
        w = torch.exp(last - cs) * dtt
        decay = torch.exp(cs[..., :, None] - cs[..., None, :])
        M = torch.where(lower, (Ct @ Bt.transpose(-1, -2)) * decay
                        * dtt[..., None, :], 0.0)
        intra = sum(m @ xt for m in _bf16_parts(M, m_parts))
        inter = sum(Ct @ st.transpose(-1, -2)
                    for st in _bf16_parts(state, state_parts))
        ys.append((intra + inter * torch.exp(cs)[..., None])
                  + xt * D[:, None, None])
        xw = xt * w[..., None]
        state = state * torch.exp(last)[..., None] + sum(
            part.transpose(-1, -2) @ Bt for part in _bf16_parts(xw, xw_parts))
    y = torch.cat(ys, dim=2)[:, :, :s].movedim(2, 1)
    return y.bfloat16(), state


def test_tile_cumsum_is_a_cumulative_sum():
    d = torch.from_numpy(-np.abs(np.random.default_rng(9).standard_normal(
        (3, TILE))).astype(np.float32))
    cs = _tile_cumsum(d)
    torch.testing.assert_close(cs, d.double().cumsum(-1).float(),
                               atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def budget_case():
    """B = 2, S = 1024, H = 4, P = 64, N = 128: x, B, C rounded to bf16,
    and the Pallas kernel's answer on them in interpret mode (8 programs
    of 4 chunks of 256)."""
    x, dt, A, B, C, D = _inputs(2, 1024, 4, 64, 1, 128, seed=11)
    x, B, C = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (x, B, C))
    jargs, targs = _both((x, dt, A, B, C, D))
    jy, jst = jssd_kernel(*jargs, chunk=256, interpret=True)
    ref = (torch.from_numpy(np.array(jy, np.float32)),
           torch.from_numpy(np.array(jst, np.float32)))
    return targs, ref


def test_ssd_kernel_error_budget_holds(budget_case):
    """The kernel's rounding, hi + lo splits included, passes the card's
    gates against the Pallas kernel with a wide margin."""
    targs, (jy, jst) = budget_case
    y, st = _emulate_ssd_kernel(*targs)
    assert y.shape == jy.shape and st.shape == jst.shape
    assert row_rel_err(y, jy) <= SSD_Y_ROW_RTOL
    assert row_rel_err(st, jst) <= SSD_STATE_ROW_RTOL / 10


def test_ssd_single_bf16_rounding_breaks_the_state_gate(budget_case):
    """One bf16 rounding of x w and the state (no lo part) moves the final
    state past its gate: the split is what the budget rests on."""
    targs, (jy, jst) = budget_case
    _, st = _emulate_ssd_kernel(*targs, state_parts=1, xw_parts=1)
    assert row_rel_err(st, jst) > SSD_STATE_ROW_RTOL
