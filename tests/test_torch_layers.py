"""The PyTorch port's configs and layer functions against the JAX package's,
on the same numpy inputs.

Tolerances: fp32 to 2e-5 (the same fp32 arithmetic, summed in another
order); bf16 to 4e-2 (one bf16 rounding of values of order 1 is up to
~4e-3, and the two frameworks round intermediates at different places).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tL

FP32_TOL = 2e-5
BF16_TOL = 4e-2


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, dtype=getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    full_j, full_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert full_t.param_count() == full_j.param_count()
    assert (dataclasses.asdict(tconfigs.get_tiny(arch))
            == dataclasses.asdict(jconfigs.get_tiny(arch)))
    assert (dataclasses.asdict(tconfigs.reduced(full_t, dtype="float32"))
            == dataclasses.asdict(jconfigs.reduced(full_j, dtype="float32")))


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    (xj, xt), (sj, st) = _pair(x, dtype), _pair(scale, "float32")
    out = tL.rms_norm(xt, st, 1e-5)
    assert out.dtype == xt.dtype
    _close(jL.rms_norm(xj, sj, 1e-5), out, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_swiglu(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ws = [0.2 * rng.standard_normal(s).astype(np.float32)
          for s in ((32, 48), (32, 48), (48, 32))]
    xj, xt = _pair(x, dtype)
    wj, wt = zip(*(_pair(w, "float32") for w in ws))
    _close(jL.swiglu(xj, *wj), tL.swiglu(xt, *wt), tol)


@pytest.mark.parametrize("head_dim,theta", [(64, 1e6), (128, 1e4)])
def test_rope_freqs(head_dim, theta):
    _close(jL.rope_freqs(head_dim, theta), tL.rope_freqs(head_dim, theta),
           1e-6)


@pytest.mark.parametrize("dtype,tol,batched", [
    ("float32", FP32_TOL, False), ("float32", FP32_TOL, True),
    ("bfloat16", BF16_TOL, False)])
def test_apply_rope(dtype, tol, batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = (rng.integers(0, 4000, (2, 7)) if batched
           else np.arange(100, 107)).astype(np.int32)
    xj, xt = _pair(x, dtype)
    out = tL.apply_rope(xt, torch.from_numpy(pos), 1e6)
    assert out.dtype == xt.dtype
    # fp32 angles up to ~4000 rad: cos/sin agree to a few ulps of the angle
    _close(jL.apply_rope(xj, jnp.asarray(pos), 1e6), out,
           max(tol, 1e-4) if batched else tol)


def test_embed():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 4)).astype(np.int32)
    tj, tt = _pair(table, "float32")
    out = tL.embed(torch.from_numpy(toks).long(), tt, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jL.embed(jnp.asarray(toks), tj, jnp.bfloat16), np.float32),
        out.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_fp32_logits(dtype):
    """bf16 operands give fp32 logits, not bf16-rounded ones."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    table = 0.05 * rng.standard_normal((64, 300)).astype(np.float32)
    (xj, xt), (tj, tt) = _pair(x, dtype), _pair(table, dtype)
    out = tL.unembed(xt, tt)
    assert out.dtype == torch.float32
    # products of bf16 values are exact in fp32: only the summation order
    # differs, so fp32 agreement holds for bf16 operands too
    _close(jL.unembed(xj, tj), out, FP32_TOL)
