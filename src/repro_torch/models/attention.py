"""Grouped-query attention in plain PyTorch: chunked online softmax for
prefill, single-token decode against a ring KV cache, and the cache helpers.
Counterpart of the JAX package's ``models/attention.py``.

Conventions:
  q: [B, S, Hq, Dh]; k/v: [B, S, Hkv, Dh], Hq = G * Hkv (GQA groups G).
  KV cache per layer: {"k": [B, W, Hkv, Dh], "v": same,
                       "slot_pos": [W] int32 absolute position per slot
                       (-1 = empty)}, where W = max_len (full) or window (SWA).
Unlike the JAX versions, the cache helpers write into the cache they are
given (the reference donates it) and return it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """Additive mask bias [Sq, Sk]: 0 where attendable, NEG_INF otherwise."""
    ok = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      window: int = 0, q_chunk: int = 1024,
                      k_chunk: int = 1024,
                      skip_masked_blocks: bool = True) -> torch.Tensor:
    """Causal GQA attention via chunked online softmax, in fp32.

    q: [B, Sq, Hq, Dh]; k/v: [B, Sk, Hkv, Dh]; q_pos: [Sq]; k_pos: [Sk]
    (k_pos < 0 marks an empty slot). Returns [B, Sq, Hq, Dh] in q's dtype.
    ``skip_masked_blocks`` skips KV chunks no query of the chunk can reach.
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((b, sq, hq, dh), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qb = q[:, q0:q0 + q_chunk].float()
        n = qb.shape[1]
        qg = qb.reshape(b, n, hkv, g, dh)
        qp = q_pos[q0:q0 + n]
        qp_max, qp_min = int(qp.max()), int(qp.min())
        m = torch.full((b, hkv, g, n), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, n), device=q.device)
        acc = torch.zeros((b, hkv, g, n, dh), device=q.device)
        for k0 in range(0, k.shape[1], k_chunk):
            kp = k_pos[k0:k0 + k_chunk]
            if skip_masked_blocks:
                valid = kp[kp >= 0]
                reachable = valid.numel() > 0 and int(valid.min()) <= qp_max
                if window > 0:
                    reachable = reachable and int(kp.max()) > qp_min - window
                if not reachable:
                    continue
            kb = k[:, k0:k0 + k_chunk].float()
            vb = v[:, k0:k0 + k_chunk].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
            s = s + _mask_bias(qp, kp, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vb)
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]  # [B, Hkv, G, n, Dh]
        out[:, q0:q0 + n] = o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     q_abs_pos: int, *, window: int = 0) -> torch.Tensor:
    """One-token decode: q [B, 1, Hq, Dh] against cache [B, W, Hkv, Dh],
    in fp32. slot_pos: [W] absolute positions per slot (-1 empty)."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(dh)
    ok = (slot_pos >= 0) & (slot_pos <= q_abs_pos)
    if window > 0:
        ok &= slot_pos > (q_abs_pos - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def distributed_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, slot_pos: torch.Tensor,
                                 q_abs_pos: int, *, window: int = 0,
                                 reduce=None) -> torch.Tensor:
    """``decode_attention`` over one shard of the cache's slots: the
    reference's distributed online softmax (``_decode_attn``). ``reduce(t,
    op)`` reduces a tensor over the shards holding the other slots ("max"
    or "sum"): the row max m, then l = sum exp(s - m) and o = sum p v, and
    the output o / max(l, 1e-30). Its one-device case (``reduce`` None,
    the cache whole on this device) is ``decode_attention``, bit for bit."""
    if reduce is None:
        return decode_attention(q, k_cache, v_cache, slot_pos, q_abs_pos,
                                window=window)
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(dh)
    ok = (slot_pos >= 0) & (slot_pos <= q_abs_pos)
    if window > 0:
        ok &= slot_pos > (q_abs_pos - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, NEG_INF)
    m = reduce(s.amax(dim=-1), "max")
    p = torch.exp(s - m[..., None])
    l = reduce(p.sum(dim=-1), "sum")
    o = reduce(torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()), "sum")
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def init_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int, *,
               device: torch.device | str,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                               device=device),
    }


def cache_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor) -> dict:
    """Write a full prefill [B, S, ...] into the cache, in place.
    For a rolling (window) cache with S > W, keeps the last W entries."""
    w = cache["k"].shape[1]
    if k.shape[1] >= w:
        k, v, positions = k[:, -w:], v[:, -w:], positions[-w:]
    slots = (positions % w).long()
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["slot_pos"][slots] = positions.to(torch.int32)
    return cache


def cache_append(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 pos: int) -> dict:
    """Append one token (k/v: [B, 1, Hkv, Dh]) at absolute position ``pos``,
    in place."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    return cache
