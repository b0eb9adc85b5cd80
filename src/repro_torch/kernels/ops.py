"""Kernel entry points in the model's tensor layout.

A tensor on the CPU goes to the plain version, through which autograd
differentiates; a CUDA tensor goes to the hand-written kernel, which raises
on anything it cannot take. No path falls back from the kernel to the
plain version, and no kernel output that needs a gradient lacks one: on
the card attention differentiates through the backward kernel, and the
SSD scan, which has none yet, refuses inputs that require a gradient.
Launch configurations are fixed inside the kernels for now; per-shape
tuning is a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
from repro_torch.kernels.ref import attention_reference, ssd_chunked_reference
from repro_torch.kernels.ssd import ssd_chunked_kernel


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its LSE saved, and the backward kernel: the
    counterpart of ``jax.grad`` through the JAX model's attention. Under
    ``torch.use_deterministic_algorithms(True)`` the backward sums in a
    fixed order, so its gradients are bit-identical from call to call, as
    ``jax.grad``'s are."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_deterministic
               if torch.are_deterministic_algorithms_enabled()
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, lse, dout.contiguous(), causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh] ->
    [B, S, Hq, Dh]."""
    if q.device.type == "cpu":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = attention_reference(qt, kt, vt, causal=causal, window=window)
        return out.transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int):
    """Model layout: x [B, S, H, P], dt [B, S, H], A/D [H], B/C [B, S, G, N]
    -> (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] fp32).
    ``chunk`` is the plain version's chunk, as the JAX model passes it; the
    kernel picks its own tile along S."""
    if x.device.type == "cpu":
        return ssd_chunked_reference(x, dt, A, B, C, D, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        raise NotImplementedError(
            "ssd_op: the SSD kernel has no backward yet (ROADMAP.md A.3), "
            "so its output would carry no gradient; run it under "
            "torch.no_grad() or on the CPU")
    return ssd_chunked_kernel(x, dt, A, B, C, D)
