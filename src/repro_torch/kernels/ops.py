"""Kernel entry points in the model's tensor layout.

A tensor on the CPU goes to the plain version, through which autograd
differentiates; a CUDA tensor goes to the hand-written kernel, which raises
on anything it cannot take. No path falls back from the kernel to the
plain version, and no kernel output that needs a gradient lacks one: on
the card attention and the SSD scan differentiate through their backward
kernels. Launch configurations are fixed inside the kernels for now;
per-shape tuning is a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
from repro_torch.kernels.ref import attention_reference, ssd_chunked_reference
from repro_torch.kernels.ssd import ssd_chunked_bwd_kernel, ssd_chunked_kernel


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


class _SSDScan(torch.autograd.Function):
    """The forward kernel, its inputs saved, and the backward kernel: the
    counterpart of ``jax.grad`` through the JAX model's ``ssd_chunked``,
    bit-identical from call to call as that is. The final state's gradient
    is not computed (the train path drops the state): a caller whose loss
    reaches the state gets an error, not a gradient without that part."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, state = ssd_chunked_kernel(x, dt, A, B, C, D)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "ssd_op: the SSD backward kernel takes no gradient of the "
                "final state; drop the state, or differentiate on the CPU")
        if dy is None:
            return (None,) * 6
        return ssd_chunked_bwd_kernel(*ctx.saved_tensors, dy.contiguous())


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
        return _SSDScan.apply(x, dt, A, B, C, D)
    return ssd_chunked_kernel(x, dt, A, B, C, D)
