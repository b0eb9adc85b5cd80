"""Mamba2 (SSD, state space duality, arXiv:2405.21060) block in PyTorch:
the counterpart of the JAX package's ``models/ssm.py``, rounding where it
rounds.

Within a chunk the recurrence is a masked, decay-weighted quadratic
product; across chunks a loop carries the [H, P, N] state. On the card the
prefill runs ``repro_torch.kernels.ssd`` instead, held against these.

Shapes:
  x   [B, S, H, P]   (P = head_dim)
  dt  [B, S, H]      (post softplus, > 0)
  A   [H]            (negative reals: -exp(A_log))
  B,C [B, S, G, N]   (G groups share B/C across H // G heads)
  state [B, H, P, N]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} dA[..., k] for i >= j, -inf above
    the diagonal. dA: [..., L]; returns [..., L, L]."""
    l = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                device=dA.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int, init_state: torch.Tensor | None = None,
                return_state: bool = False,
                compute_dtype: torch.dtype = torch.float32):
    """Chunked SSD scan. Returns y [B, S, H, P] in x's dtype (and the fp32
    final state [B, H, P, N] if ``return_state``). ``compute_dtype`` is the
    type of the intra-chunk products; the decays and the state stay fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk

    f32, cd = torch.float32, compute_dtype
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()

    dA = dtc * A.float()                  # [b, nc, l, h]
    cs = torch.cumsum(dA, dim=2)          # within-chunk cumulative
    xdt = xc * dtc[..., None]             # [b, nc, l, h, p]

    # intra-chunk (diagonal blocks)
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc.to(cd), Bc.to(cd))
    Lm = torch.exp(segsum(dA.permute(0, 1, 3, 2)))  # [b, nc, h, i, j]
    Lh = Lm.reshape(b, nc, g, hg, chunk, chunk)
    y_diag = torch.einsum("bcijg,bcghij,bcjghp->bcighp", scores.to(cd),
                          Lh.to(cd),
                          xdt.reshape(b, nc, chunk, g, hg, p).to(cd))
    y_diag = y_diag.reshape(b, nc, chunk, h, p).to(f32)

    # per-chunk end states: decay from step j to the end of its chunk
    dec_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("bclgn,bclgh,bclghp->bcghpn", Bc,
                          dec_end.reshape(b, nc, chunk, g, hg),
                          xdt.reshape(b, nc, chunk, g, hg, p))
    states = states.reshape(b, nc, h, p, n)

    # inter-chunk recurrence
    chunk_decay = torch.exp(dA.sum(dim=2))  # [b, nc, h]
    carry = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [b, nc, h, p, n]

    # inter-chunk contribution: decay from the chunk's start to step i
    y_off = torch.einsum("bcign,bcghpn,bcigh->bcighp", Cc,
                         prev_states.reshape(b, nc, g, hg, p, n),
                         torch.exp(cs).reshape(b, nc, chunk, g, hg))
    y_off = y_off.reshape(b, nc, chunk, h, p)

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    y = y + x[:, :s].float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, carry
    return y


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor):
    """One-token recurrent update. state [B, H, P, N]; x [B, H, P];
    dt [B, H]; B/C [B, G, N]. Returns (y [B, H, P] in x's dtype,
    new_state in state's dtype)."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    hg = h // g
    dA = torch.exp(dt.float() * A.float())      # [B, H]
    xdt = x.float() * dt.float()[..., None]     # [B, H, P]
    upd = torch.einsum("bgn,bghp->bghpn", B.float(),
                       xdt.reshape(b, g, hg, p)).reshape(b, h, p, n)
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bgn,bghpn->bghp", C.float(),
                     new_state.reshape(b, g, hg, p, n)).reshape(b, h, p)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), new_state.to(state.dtype)


def ssd_reference(x, dt, A, B, C, D, init_state=None):
    """Naive step-by-step recurrence (fp32 state). Returns (y, state)."""
    b, s, h, p = x.shape
    n = B.shape[3]
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(state, x[:, t].float(), dt[:, t], A,
                                   B[:, t], C[:, t], D)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                init_state: torch.Tensor | None = None):
    """Depthwise causal conv. x [B, S, Ch]; w [W, Ch]; b [Ch].
    Returns (silu(y) [B, S, Ch], tail state [B, W-1, Ch]). Each tap is
    multiplied and added in x's dtype, the weights cast to it at use, as
    the reference does. ``init_state`` is the previous W-1 inputs."""
    width = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    tail = xp[:, -(width - 1):] if width > 1 else init_state
    return F.silu(y), tail


def conv_decode_step(conv_state: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor):
    """One-token conv update in fp32, rounded once to x's dtype.
    conv_state [B, W-1, Ch]; x [B, Ch]. Returns (y [B, Ch], new state)."""
    width = w.shape[0]
    full = torch.cat([conv_state, x[:, None].to(conv_state.dtype)], dim=1)
    y = torch.einsum("bwc,wc->bc", full.float(), w.float()) + b.float()
    new_state = full[:, 1:] if width > 1 else conv_state
    return F.silu(y).to(x.dtype), new_state.to(conv_state.dtype)
