"""Shared layer primitives: RMSNorm, SwiGLU MLP, rotary embeddings (with
M-RoPE), embedding tables. Plain functions over tensors, rounding where
the JAX package's ``models/layers.py`` rounds."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: fp32 variance; the factor ``rsqrt(var + eps)`` is rounded to
    the input dtype before the two multiplies, which stay in that dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def swiglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
           down_w: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    g = F.silu(x @ gate_w.to(x.dtype))
    u = x @ up_w.to(x.dtype)
    return (g * u) @ down_w.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (fp32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, Dh] by fp32 angles [B, S, half] (or [1, S,
    half]): bf16 * fp32 promotes to fp32, as in JAX; one rounding at the
    end."""
    cos = torch.cos(ang)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard 1-D RoPE.  x: [B, S, H, Dh]; positions: [S] or [B, S]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv  # [(B,) S, half]
    if ang.dim() == 2:
        ang = ang[None]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): 3-D rotary with per-section position streams.

    x: [B, S, H, Dh]; positions: [B, S, 3] int (temporal, height, width).
    ``sections`` partitions the ``Dh/2`` frequency slots among the three
    streams: slot j rotates by stream ``sel[j]``'s position times the
    slot's frequency, the product the reference selects from its
    [B, S, half, 3] angles. With the three streams equal it is
    ``apply_rope``'s product, so the result is bit-equal to it."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} do not "
                         f"sum to head_dim / 2 = {half}")
    inv = rope_freqs(x.shape[-1], theta, x.device)
    # each slot's stream, from the section bounds known on the host
    j = torch.arange(half, device=x.device)
    sel = (j >= sections[0]).long() + (j >= sections[0] + sections[1]).long()
    ang = positions[..., sel].float() * inv  # [B, S, half]
    return _rotate(x, ang)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``tokens``, cast after the gather: the reference's
    cast-then-gather values, without a cast copy of a whole fp32 table."""
    return table[tokens].to(compute_dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """fp32 logits of bf16 operands. A bf16 x bf16 product is exact in
    fp32, so the fp32 product of the upcast operands, with TF32 off, is the
    reference's bf16-operand, fp32-accumulate dot. Callers that unembed
    often pass the table already in fp32, so it is not re-cast per call."""
    return x.float() @ table.float()
