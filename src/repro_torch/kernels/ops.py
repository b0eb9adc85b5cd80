"""Kernel entry points in the model's tensor layout.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
hand-written kernel, which raises on anything it cannot take. No path
falls back from the kernel to the plain version. Launch configurations are
fixed inside the kernel for now; per-shape tuning is a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_reference, ssd_chunked_reference
from repro_torch.kernels.ssd import ssd_chunked_kernel


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh] ->
    [B, S, Hq, Dh]."""
    if q.device.type == "cpu":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = attention_reference(qt, kt, vt, causal=causal, window=window)
        return out.transpose(1, 2)
    return flash_attention(q, k, v, causal=causal, window=window)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int):
    """Model layout: x [B, S, H, P], dt [B, S, H], A/D [H], B/C [B, S, G, N]
    -> (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] fp32).
    ``chunk`` is the plain version's chunk, as the JAX model passes it; the
    kernel picks its own tile along S."""
    if x.device.type == "cpu":
        return ssd_chunked_reference(x, dt, A, B, C, D, chunk=chunk)
    return ssd_chunked_kernel(x, dt, A, B, C, D)
