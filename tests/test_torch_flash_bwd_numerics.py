"""The flash backward kernel's arithmetic, emulated in PyTorch on the CPU,
against ``jax.grad`` of the JAX model's ``chunked_attention`` in fp32.

csrc/flash_attention_bwd.cu cannot run here (no nvcc, no card), so this
file repeats its rounding and summation order in plain PyTorch and holds
that against the reference: P from the forward's LSE; delta = rowsum(P o
dP) summed exactly in fp32 (its own pass); P and dS rounded to bf16 before
their products, with fp32 sums; dQ as fp32 partials of one 64-key tile
each, and dK and dV as fp32 partials of one q head each, added in an order
that a seed shuffles (the kernels add them by atomics, in the order the
blocks finish); each output rounded to bf16 once. The inputs are bf16
values, made with numpy from a seed; the reference sees the same values in
fp32.

Tolerance, as the card's gate in chip_smoke.py: the worst row's relative L2
error (``row_rel_err``, each row's norm raised to at least 1% of the median
row norm, since row 0 of dQ cancels to zero under a causal mask) at most
2e-2. bf16 roundings of P, dS and the outputs (2^-9 relative per term)
leave a sound emulation at ~4e-3.

One case takes delta as rowsum(dO o O) from the forward's bf16 output, as
FlashAttention-2 and SDPA do: on a causal head's first rows, whose dQ
cancels to a small vector, the forward's bf16 rounding of P reaches dQ
through O, and that variant errs more than the exact delta. That is why the
kernel keeps its delta pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import BWD_KEY_TILE
from repro_torch.kernels.ref import row_rel_err

GRAD_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2

# (B, Hq, Hkv, Sq, Sk, D, window); every case causal, as chunked_attention is
CASES = {
    "causal": (1, 8, 2, 256, 256, 64, 0),
    "window": (1, 8, 2, 256, 256, 64, 100),   # a window that crosses tiles
    "ragged": (1, 4, 2, 150, 150, 128, 0),    # S not a multiple of 64
    "sk_gt_sq": (1, 4, 2, 100, 300, 64, 0),   # Sk > Sq, positions from 0
    "gqa4_d128": (2, 8, 2, 192, 192, 128, 0),  # a group of 4 at D = 128
    "group1": (1, 4, 4, 128, 128, 64, 32),
}


def _inputs(b, hq, hkv, sq, sk, d, seed):
    """q, k, v, dO as bf16 values in fp32 numpy arrays, [B, S, H, D]."""
    rng = np.random.default_rng(seed)
    out = []
    for s, h in ((sq, hq), (sk, hkv), (sk, hkv), (sq, hq)):
        x = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
        out.append(x.bfloat16().float().numpy())
    return out


def _jax_grads(q, k, v, do, window):
    sq, sk = q.shape[1], k.shape[1]

    def loss(q, k, v):
        out = jattn.chunked_attention(q, k, v, jnp.arange(sq, dtype=jnp.int32),
                                      jnp.arange(sk, dtype=jnp.int32),
                                      window=window, q_chunk=64, k_chunk=64)
        return jnp.sum(out * do)

    return [np.array(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _shuffled_sum(parts, gen):
    """fp32 sum of ``parts`` added one at a time in a shuffled order."""
    total = torch.zeros_like(parts[0])
    for i in torch.randperm(len(parts), generator=gen).tolist():
        total = total + parts[i]
    return total


def emulate_backward(q, k, v, do, window, *, seed=0, delta_from_output=False):
    """dQ, dK, dV [B, S, H, D] in bf16 values (as fp32), computed as the
    kernels compute them; ``delta_from_output`` takes delta = rowsum(dO o
    O) from the forward's bf16 output instead of the exact rowsum(P o dP)."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do))
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kh, vh = (x.repeat_interleave(group, dim=1) for x in (k, v))
    r = torch.arange(sq)[:, None]
    c = torch.arange(sk)[None, :]
    ok = r >= c
    if window:
        ok &= c > r - window
    s = torch.where(ok, q @ kh.transpose(-1, -2) * scale, torch.tensor(-1e30))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)        # the forward's LSE
    p = torch.where(ok, torch.exp(s - lse), torch.tensor(0.0))
    dp = do @ vh.transpose(-1, -2)
    if delta_from_output:
        o = _bf16(_bf16(p) @ vh)  # the forward rounds P, then O, to bf16
        delta = (do * o).sum(-1, keepdim=True)
    else:
        delta = (p * dp).sum(-1, keepdim=True)            # the delta pass
    ds = p * (dp - delta)
    p_b, ds_b = _bf16(p), _bf16(ds)
    gen = torch.Generator().manual_seed(seed)
    tiles = [slice(t, min(t + BWD_KEY_TILE, sk)) for t in range(0, sk, BWD_KEY_TILE)]
    dq = _shuffled_sum([ds_b[..., t] @ kh[:, :, t] for t in tiles], gen) * scale
    dk_h = ds_b.transpose(-1, -2) @ q          # [B, Hq, Sk, D], per q head
    dv_h = p_b.transpose(-1, -2) @ do
    dk = torch.stack([_shuffled_sum(list(dk_h[:, h * group:(h + 1) * group].unbind(1)),
                                    gen) for h in range(hkv)], 1) * scale
    dv = torch.stack([_shuffled_sum(list(dv_h[:, h * group:(h + 1) * group].unbind(1)),
                                    gen) for h in range(hkv)], 1)
    return [_bf16(x).transpose(1, 2) for x in (dq, dk, dv)]


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_matches_jax_grad(name):
    b, hq, hkv, sq, sk, d, window = CASES[name]
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d, seed=sq + sk + d + window)
    refs = _jax_grads(q, k, v, do, window)
    grads = emulate_backward(q, k, v, do, window, seed=1)
    for label, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        err = row_rel_err(g, torch.from_numpy(ref), floor=GRAD_ROW_FLOOR)
        assert err <= GRAD_ROW_RTOL, (label, err)


def test_summation_order_moves_only_low_bits():
    """Two shuffles of the cross-block sums, as two runs of the kernel
    would add them: the outputs differ by bf16 roundings at most."""
    q, k, v, do = _inputs(1, 8, 2, 256, 256, 64, seed=5)
    first = emulate_backward(q, k, v, do, 0, seed=1)
    second = emulate_backward(q, k, v, do, 0, seed=2)
    for a, b in zip(first, second):
        assert row_rel_err(a, b, floor=GRAD_ROW_FLOOR) <= 2 ** -7


def test_delta_from_the_bf16_output_errs_more():
    """delta = rowsum(dO o O) with O the forward's bf16 output against the
    exact delta, on the first rows of a causal head: there dQ cancels (row
    1 sees two keys), and the forward's bf16 rounding of P moves it."""
    q, k, v, do = _inputs(1, 4, 2, 256, 256, 64, seed=11)
    dq_ref = torch.from_numpy(_jax_grads(q, k, v, do, 0)[0])
    exact = emulate_backward(q, k, v, do, 0)[0]
    from_output = emulate_backward(q, k, v, do, 0, delta_from_output=True)[0]
    first = slice(0, 16)
    # the floor is taken over all rows, as the card's gate takes it
    floor = GRAD_ROW_FLOOR * dq_ref.norm(dim=-1).median().item()

    def worst(g):
        diff = (g[:, first] - dq_ref[:, first]).norm(dim=-1)
        return (diff / dq_ref[:, first].norm(dim=-1).clamp_min(floor)).max().item()
    err_exact, err_output = worst(exact), worst(from_output)
    print(f"dQ worst row over rows 0-15: exact delta {err_exact:.3e}, "
          f"delta from the bf16 output {err_output:.3e}")
    assert err_exact <= GRAD_ROW_RTOL
    assert err_output > 2 * err_exact
