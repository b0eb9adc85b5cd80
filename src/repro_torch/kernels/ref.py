"""Plain PyTorch versions of the kernels: what the CPU path runs and what
every kernel is held against on the card."""

from __future__ import annotations

import math

import torch

from repro_torch.models import ssm

NEG_INF = -1e30


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: int) -> torch.Tensor:
    """fp32 scaled scores [B, Hkv, G, Sq, Sk], NEG_INF where masked."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive softmax attention.  q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D].

    Positions count from 0 for both q and k (top-left aligned when
    Sq != Sk), as in the flash kernel.
    """
    b, hq, sq, d = q.shape
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0):
    """``attention_reference`` and each row's natural-log log-sum-exp of
    the scaled scores over its visible keys, [B, Hq, Sq] fp32: what the
    forward kernel writes with ``return_lse``."""
    b, hq, sq, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window), dim=-1)
    return (attention_reference(q, k, v, causal=causal, window=window),
            lse.reshape(b, hq, sq))


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True, window: int = 0):
    """dQ, dK, dV of ``attention_reference`` for the output gradient ``do``
    (q's shape), by ``torch.autograd`` in fp32 from the given (bf16)
    inputs; the layout is ``attention_reference``'s. Returns fp32 tensors
    in q's, k's and v's shapes."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention_reference(qf, kf, vf, causal=causal, window=window)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def ssd_reference(x, dt, A, B, C, D, init_state=None):
    """Naive Mamba2 recurrence, step by step. See
    ``repro_torch.models.ssm.ssd_reference``."""
    return ssm.ssd_reference(x, dt, A, B, C, D, init_state=init_state)


def ssd_chunked_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                          *, chunk: int = 256):
    """The SSD kernel's plain version: the chunked scan the JAX model runs,
    ``ssd_chunked(..., return_state=True)``. x [B, S, H, P]; dt [B, S, H];
    A, D [H]; B/C [B, S, G, N]. Returns (y in x's dtype, fp32 final state
    [B, H, P, N])."""
    return ssm.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, return_state=True)


def row_rel_err(out: torch.Tensor, ref: torch.Tensor, *,
                floor: float = 0.0) -> float:
    """The largest relative L2 error of one output row (the last axis) of a
    kernel against its plain version: max over rows of |out - ref| / |ref|,
    where |ref| is raised to at least ``floor`` times the median row norm.

    An absolute limit cannot judge attention: a causal row over n keys of
    N(0, 1) values has entries of size ~1/sqrt(n), so outputs range from ~1
    (row 0) to ~0.03 (row 1023), and a limit that admits the rounding of
    the first rows admits errors of the size of the last rows' values. A
    row's relative error is one scale for every row, and one wrong row
    shows however many right ones surround it.

    ``floor`` is for gradients, whose rows can cancel to zero exactly: under
    a causal mask row 0 of dQ sees one key, so dS = P (dP - delta) = 0, and
    any rounding of dP - delta is infinitely many times that row's norm."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    least = max(1e-30, floor * norm.median().item())
    return (diff / norm.clamp_min(least)).max().item()
