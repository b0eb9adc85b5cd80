"""The q position offset of the flash kernels' plain versions and costs:
a sequence shard's q rows at positions offset + arange against the whole
sequence's keys, as the reference's sequence-sharded attention runs
``chunked_attention`` (``q_pos`` the shard's, ``k_pos`` the sequence's),
forward and ``jax.grad``; the FLOP counts of the shards summing to the
unsharded count; and the decode's softmax over shards of the ring."""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention
from repro_torch.kernels.ops import attention_op
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference)
from repro_torch.roofline.kernel_cost import flash_cost, unmasked_pairs

SHAPES = [  # (B, S, Hq, Hkv, D, window, shards)
    (2, 64, 4, 2, 16, 0, 4),
    (1, 96, 4, 1, 16, 24, 4),
    (2, 48, 2, 2, 8, 0, 2),
]


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, do


def _jax_shard(q, k, v, window, off):
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    pos_k = jnp.arange(k.shape[1])
    pos_q = off + jnp.arange(q.shape[1])
    return chunked_attention(q, k, v, pos_q, pos_k, window=window,
                             q_chunk=16, k_chunk=16)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_offset_forward_is_chunked_attention_of_the_shard(shape):
    b, s, hq, hkv, d, window, shards = shape
    q, k, v, _ = _inputs(b, s, hq, hkv, d)
    n = s // shards
    rows = []
    for i in range(shards):
        off = i * n
        qs = q[:, off:off + n]
        want = np.asarray(_jax_shard(qs, k, v, window, off))
        got = attention_op(_t(qs), _t(k), _t(v), causal=True, window=window,
                           q_offset=off)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
        rows.append(got)
    whole = attention_op(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), whole.numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_offset_backward_is_jax_grad_of_the_shard(shape):
    b, s, hq, hkv, d, window, shards = shape
    q, k, v, do = _inputs(b, s, hq, hkv, d, seed=1)
    n = s // shards
    dk_sum = np.zeros_like(k)
    dv_sum = np.zeros_like(v)
    for i in range(shards):
        off = i * n
        qs, dos = q[:, off:off + n], do[:, off:off + n]

        def loss(qq, kk, vv):
            return jnp.sum(_jax_shard(qq, kk, vv, window, off) * dos)

        want = jax.grad(loss, argnums=(0, 1, 2))(qs, k, v)
        got = attention_backward_reference(
            *(_t(x).transpose(1, 2) for x in (qs, k, v, dos)),
            causal=True, window=window, q_offset=off)
        got = [g.transpose(1, 2).numpy() for g in got]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=5e-5,
                                       rtol=1e-4)
        dk_sum += got[1]
        dv_sum += got[2]
    # the shards' dK and dV sum to the unsharded gradients
    whole = attention_backward_reference(
        *(_t(x).transpose(1, 2) for x in (q, k, v, do)), causal=True,
        window=window)
    np.testing.assert_allclose(dk_sum, whole[1].transpose(1, 2).numpy(),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(dv_sum, whole[2].transpose(1, 2).numpy(),
                               atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_offset_lse_rows_are_the_unsharded_rows(shape):
    b, s, hq, hkv, d, window, shards = shape
    q, k, v, _ = _inputs(b, s, hq, hkv, d, seed=2)
    qt, kt, vt = (_t(x).transpose(1, 2) for x in (q, k, v))
    _, whole = attention_lse_reference(qt, kt, vt, window=window)
    n = s // shards
    for i in range(shards):
        _, lse = attention_lse_reference(qt[:, :, i * n:(i + 1) * n], kt, vt,
                                         window=window, q_offset=i * n)
        torch.testing.assert_close(lse, whole[:, :, i * n:(i + 1) * n])


@pytest.mark.parametrize("sq,window,shards", [
    (2048, 0, 4), (2048, 4096, 4), (4096, 0, 16), (4096, 1024, 16),
    (1000, 0, 4), (1000, 128, 8)])
def test_shard_flops_sum_to_the_unsharded_count(sq, window, shards):
    """The visible pairs of each shard (``unmasked_pairs`` with the
    offset, which the operators' FLOP formulas take) sum to the whole
    sequence's; the kernel's tile count too when the offsets are whole q
    tiles."""
    n = -(-sq // shards)
    offsets = range(0, sq, n)
    total = sum(unmasked_pairs(min(n, sq - off), sq, True, window, off)
                for off in offsets)
    assert total == unmasked_pairs(sq, sq, True, window)
    if n % 128 == 0:
        tiles = sum(flash_cost(1, 1, 1, n, sq, 128, window=window,
                               q_offset=off)[0] *
                    flash_cost(1, 1, 1, n, sq, 128, window=window,
                               q_offset=off)[2] for off in offsets)
        f, _, steps = flash_cost(1, 1, 1, sq, sq, 128, window=window)
        assert tiles == f * steps


def test_offset_is_refused_below_zero():
    q = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError):
        from repro_torch.kernels.flash_attention import _check_positions
        _check_positions(0, -1, "flash_attention")
    assert attention_reference(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2), q_offset=3).shape == \
        (1, 1, 8, 16)


@pytest.mark.parametrize("window", [0, 24])
def test_distributed_decode_softmax_over_cache_shards(window):
    """The decode's online softmax over 4 shards of the ring's slots, the
    shards' maxima and sums reduced across them, is ``decode_attention``
    over the whole ring; without a reduction (one device) it is it, bit
    for bit."""
    from repro_torch.models.attention import (decode_attention,
                                              distributed_decode_attention)
    gen = torch.Generator().manual_seed(4)
    b, w, hq, hkv, d, pos = 2, 64, 4, 2, 16, 50
    q = torch.randn((b, 1, hq, d), generator=gen)
    k, v = (torch.randn((b, w, hkv, d), generator=gen) for _ in range(2))
    sp = torch.arange(w, dtype=torch.int32)
    sp[pos + 1:] = -1
    want = decode_attention(q, k, v, sp, pos, window=window)
    assert torch.equal(distributed_decode_attention(q, k, v, sp, pos,
                                                    window=window), want)
    n = w // 4
    shards = [(k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
               sp[i * n:(i + 1) * n]) for i in range(4)]
    # the four shards run in lockstep, one thread each; each reduction
    # combines the four shards' values, as the all-reduces do
    barrier = threading.Barrier(4)
    pending: dict = {}
    outs = [None] * 4

    def run(i):
        kc, vc, spc = shards[i]
        calls = [0]

        def reduce(t, op):
            key = calls[0]
            calls[0] += 1
            pending.setdefault(key, [None] * 4)[i] = t
            barrier.wait(timeout=60)
            vals = torch.stack(pending[key])
            barrier.wait(timeout=60)
            return vals.amax(0) if op == "max" else vals.sum(0)

        outs[i] = distributed_decode_attention(q, kc, vc, spc, pos,
                                               window=window, reduce=reduce)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
