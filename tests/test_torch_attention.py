"""The port's attention against the JAX package's: the kernel entry point
(its plain CPU path) against the Pallas kernel in interpret mode and the
naive oracle, the chunked and decode attention, and the ring-cache helpers.
The CUDA kernel itself is held against its plain version in
tests/test_torch_kernels.py.

Tolerances: fp32 to 2e-5, as tests/test_kernels.py holds the Pallas kernel
to the oracle; bf16 to 4e-2 (outputs of order 1 rounded to bf16 on both
sides, at different places in the two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import attention_reference as jref
from repro.models import attention as jattn
from repro_torch.kernels.ops import attention_op
from repro_torch.models import attention as tattn

FP32_TOL = 2e-5
BF16_TOL = 4e-2


def _randn(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


# tests/test_kernels.py's grid (model layout here: [B, S, H, D]) and windows
GRID = [
    (2, 4, 4, 256, 256, 64, 0),      # MHA
    (2, 4, 2, 256, 256, 64, 0),      # GQA 2:1
    (1, 8, 1, 128, 512, 64, 0),      # MQA, rectangular
    (1, 4, 2, 256, 256, 128, 0),     # head_dim 128
    (1, 2, 1, 192, 320, 64, 0),      # non-block-multiple
    (1, 4, 2, 256, 256, 64, 32),     # sliding windows
    (1, 4, 2, 256, 256, 64, 64),
    (1, 4, 2, 256, 256, 64, 100),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", GRID)
def test_attention_op_matches_pallas_and_oracle(b, hq, hkv, sq, sk, d, window):
    rng = np.random.default_rng(b * sq + d + window)
    q, k, v = (_randn(rng, (b, s, h, d))
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    out = attention_op(_t(q), _t(k), _t(v), causal=True, window=window)
    assert out.shape == (b, sq, hq, d)
    qj, kj, vj = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    pallas = jflash(qj, kj, vj, causal=True, window=window, interpret=True)
    oracle = jref(qj, kj, vj, causal=True, window=window)
    _close(pallas.transpose(0, 2, 1, 3), out, FP32_TOL)
    _close(oracle.transpose(0, 2, 1, 3), out, FP32_TOL)


def test_attention_op_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (1, 128, h, 64)) for h in (4, 2, 2))
    out = attention_op(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    _close(jflash(qj, kj, vj, causal=True, interpret=True).transpose(0, 2, 1, 3),
           out, BF16_TOL)


@pytest.mark.parametrize("sq,sk,window,q_chunk,k_chunk", [
    (96, 96, 0, 32, 32),      # self-attention, several chunks each way
    (64, 64, 24, 16, 32),     # sliding window skips whole KV chunks
    (40, 100, 0, 16, 32),     # queries at the end of a longer context
])
def test_chunked_attention(sq, sk, window, q_chunk, k_chunk):
    rng = np.random.default_rng(sq + sk + window)
    q, k, v = (_randn(rng, (2, s, h, 32)) for s, h in ((sq, 4), (sk, 2), (sk, 2)))
    q_pos = np.arange(sk - sq, sk, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    ref = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), window=window, q_chunk=q_chunk, k_chunk=k_chunk)
    out = tattn.chunked_attention(
        _t(q), _t(k), _t(v), torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        window=window, q_chunk=q_chunk, k_chunk=k_chunk)
    _close(ref, out, FP32_TOL)
    # and the kernel entry point's plain path computes the same function
    if sq == sk:
        _close(ref, attention_op(_t(q), _t(k), _t(v), window=window), FP32_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(window):
    rng = np.random.default_rng(window)
    w = 16
    q = _randn(rng, (2, 1, 4, 32))
    kc, vc = (_randn(rng, (2, w, 2, 32)) for _ in range(2))
    # a ring cache holding positions 12..23, four slots empty
    slot_pos = np.full(w, -1, np.int32)
    slot_pos[[p % w for p in range(12, 24)]] = np.arange(12, 24)
    pos = 21  # slots holding 22 and 23 are in the future
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(slot_pos),
                                 jnp.int32(pos), window=window)
    out = tattn.decode_attention(_t(q), _t(kc), _t(vc),
                                 torch.from_numpy(slot_pos), pos, window=window)
    _close(ref, out, FP32_TOL)


@pytest.mark.parametrize("s,w", [(5, 8), (8, 8), (13, 8)])
def test_cache_prefill(s, w):
    """S < W fills a prefix; S >= W keeps the last W positions."""
    rng = np.random.default_rng(s)
    k, v = (_randn(rng, (2, s, 2, 16)) for _ in range(2))
    pos = np.arange(s, dtype=np.int32)
    ref = jattn.cache_prefill(jattn.init_cache(2, w, 2, 16, jnp.float32),
                              jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    out = tattn.cache_prefill(
        tattn.init_cache(2, w, 2, 16, device="cpu", dtype=torch.float32),
        _t(k), _t(v), torch.from_numpy(pos))
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(np.asarray(ref[name]),
                                      out[name].numpy())


def test_cache_append_wraps_the_ring():
    rng = np.random.default_rng(5)
    w = 4
    jc = jattn.init_cache(1, w, 2, 8, jnp.float32)
    tc = tattn.init_cache(1, w, 2, 8, device="cpu", dtype=torch.float32)
    for pos in range(7):  # wraps past slot w-1
        k, v = (_randn(rng, (1, 1, 2, 8)) for _ in range(2))
        jc = jattn.cache_append(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(pos))
        tattn.cache_append(tc, _t(k), _t(v), pos)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(np.asarray(jc[name]), tc[name].numpy())
