"""Plain PyTorch versions of the kernels: what the CPU path runs and what
every kernel is held against on the card."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import TILE
from repro_torch.models import ssm

NEG_INF = -1e30


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: int, q_offset: int = 0) -> torch.Tensor:
    """fp32 scaled scores [B, Hkv, G, Sq, Sk], NEG_INF where masked; row
    r at position r + ``q_offset``, key j at j."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Naive softmax attention.  q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D].

    Key j stands at position j and q row r at r + ``q_offset`` (0: both
    count from 0, top-left aligned when Sq != Sk), as in the flash kernel.
    """
    b, hq, sq, d = q.shape
    p = torch.softmax(_masked_scores(q, k, causal, window, q_offset), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """``attention_reference`` and each row's natural-log log-sum-exp of
    the scaled scores over its visible keys, [B, Hq, Sq] fp32: what the
    forward kernel writes with ``return_lse``."""
    b, hq, sq, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window, q_offset),
                          dim=-1)
    return (attention_reference(q, k, v, causal=causal, window=window,
                                q_offset=q_offset),
            lse.reshape(b, hq, sq))


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 q_offset: int = 0):
    """dQ, dK, dV of ``attention_reference`` for the output gradient ``do``
    (q's shape), by ``torch.autograd`` in fp32 from the given (bf16)
    inputs; the layout is ``attention_reference``'s. Returns fp32 tensors
    in q's, k's and v's shapes."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention_reference(qf, kf, vf, causal=causal, window=window,
                                  q_offset=q_offset)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def ssd_reference(x, dt, A, B, C, D, init_state=None):
    """Naive Mamba2 recurrence, step by step. See
    ``repro_torch.models.ssm.ssd_reference``."""
    return ssm.ssd_reference(x, dt, A, B, C, D, init_state=init_state)


def ssd_chunked_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                          *, chunk: int = 256,
                          compute_dtype: torch.dtype = torch.float32):
    """The SSD kernel's plain version: the chunked scan the JAX model runs,
    ``ssd_chunked(..., return_state=True, compute_dtype=)``. x
    [B, S, H, P]; dt [B, S, H]; A, D [H]; B/C [B, S, G, N]. Returns (y in
    x's dtype, fp32 final state [B, H, P, N])."""
    return ssm.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, return_state=True,
                           compute_dtype=compute_dtype)


def ssd_backward_reference(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: torch.Tensor, dy: torch.Tensor, *,
                           chunk: int = 256,
                           compute_dtype: torch.dtype = torch.float32):
    """The SSD backward kernel's plain version: (dx, ddt, dA, dB, dC, dD) of
    ``ssd_chunked_reference``'s y for the output gradient ``dy`` (x's
    shape), by ``torch.autograd`` in fp32 from the given (bf16) inputs,
    through the intra-chunk products' casts to ``compute_dtype``, as
    ``jax.grad`` goes through the reference's. The final state's gradient
    is not an input: the train path drops the state. Returns fp32 tensors
    in the inputs' shapes."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_()
                  for t in (x, dt, A, B, C, D)]
        y, _ = ssd_chunked_reference(*leaves, chunk=chunk,
                                     compute_dtype=compute_dtype)
        return torch.autograd.grad(y, leaves, dy.float())


# The fp32 operands of the SSD backward kernel's tensor-core products, each
# split into a bf16 hi and lo part: x w and dy exp(cs) in the two walks, the
# state entering a tile and the state gradient leaving it (stored as hi / lo
# planes), and M, Q in the gradient pass.
SPLIT_OPERANDS = ("xw", "dye", "s_in", "ds_out", "m", "q")


def split_bf16(v: torch.Tensor, parts: int = 2) -> torch.Tensor:
    """v as the kernel feeds it to a bf16 tensor-core product: hi =
    bf16(v), lo = bf16(v - hi), summed exactly in fp32 (parts = 2); or hi
    alone (parts = 1)."""
    hi = v.bfloat16().float()
    return hi if parts == 1 else hi + (v - hi).bfloat16().float()


def ssd_backward_tiles(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, *, tile: int = TILE,
                       split: bool = False, hi_only: tuple[str, ...] = ()):
    """The SSD backward kernel's algorithm (``csrc/ssd_bwd.cu``) in fp32
    torch, at its tile size, in its order: a forward walk over the tiles
    for the state entering each (S <- S exp(cs_L) + (x w)^T B) and a reverse
    walk for the state gradient leaving each (dS <- dS exp(cs_L) + (dy
    exp(cs))^T C); then per (batch, group, tile) G = C B^T once and, for
    each of the group's heads in order, that head's gradients from its two
    states and its own inputs, dB / dC summed over the heads in head order.
    The order of the fp32 sums inside a product is not repeated.

    ``split`` rounds each fp32 operand of a tensor-core product
    (``SPLIT_OPERANDS``) to its bf16 hi + lo parts, as the kernel does;
    the operands named in ``hi_only`` keep the hi part alone (one bf16
    rounding). Shapes and returns as ``ssd_backward_reference``."""
    unknown = set(hi_only) - set(SPLIT_OPERANDS)
    if unknown or (hi_only and not split):
        raise ValueError(f"hi_only {hi_only}: names from {SPLIT_OPERANDS}, "
                         "with split=True")

    def rnd(name, v):
        return split_bf16(v, 1 if name in hi_only else 2) if split else v

    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pad = -s % tile
    nt = (s + pad) // tile

    def tiles(t):  # [b, s, ...] -> [b, nt, tile, ...] fp32, zeros past S
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nt, tile, *t.shape[2:])

    xt, dyt, dtt = tiles(x), tiles(dy), tiles(dt)
    Bg, Cg = tiles(B), tiles(C)                         # [b, nt, L, g, n]
    Bt = Bg.repeat_interleave(hg, dim=3)                # [b, nt, L, h, n]
    Ct = Cg.repeat_interleave(hg, dim=3)
    A, D = A.float(), D.float()
    cs = torch.cumsum(dtt * A, dim=2)                  # [b, nt, L, h]
    cs_last = cs[:, :, -1]                              # [b, nt, h]
    ecs = torch.exp(cs)
    wl = torch.exp(cs_last[:, :, None] - cs) * dtt      # exp(cs_L - cs_j) dt_j

    # the two walks, each tile's contribution a product of split operands
    s_loc = torch.einsum("btlhp,btlhn->bthpn", rnd("xw", wl[..., None] * xt),
                         Bt)
    d_loc = torch.einsum("btlhp,btlhn->bthpn",
                         rnd("dye", ecs[..., None] * dyt), Ct)
    decay = torch.exp(cs_last)[..., None, None]         # [b, nt, h, 1, 1]
    s_in, ds_out = [None] * nt, [None] * nt
    carry = torch.zeros((b, h, p, n))
    for t in range(nt):
        s_in[t] = carry
        carry = decay[:, t] * carry + s_loc[:, t]
    carry = torch.zeros((b, h, p, n))
    for t in reversed(range(nt)):
        ds_out[t] = carry
        carry = decay[:, t] * carry + d_loc[:, t]
    # stored as hi / lo planes
    s_in = rnd("s_in", torch.stack(s_in, 1))
    ds_out = rnd("ds_out", torch.stack(ds_out, 1))

    # the gradient pass: G once per (batch, group, tile), then per head;
    # exp(cs_i - cs_j) only on and below the diagonal
    G = torch.einsum("btign,btjgn->btgij", Cg, Bg).repeat_interleave(hg, 2)
    lower = torch.tril(torch.ones((tile, tile), dtype=torch.bool))
    diff = cs.transpose(2, 3)[..., :, None] - cs.transpose(2, 3)[..., None, :]
    w = torch.exp(torch.where(lower, diff, float("-inf")))   # [b, nt, h, i, j]
    q = torch.einsum("btihp,btjhp->bthij", dyt, xt)
    dt_j = dtt.transpose(2, 3)[..., None, :]
    M, Q, Fm = rnd("m", G * w * dt_j), rnd("q", w * dt_j * q), G * w * q
    U = torch.einsum("bthpn,btihp->btihn", s_in, dyt)        # S_in^T dy_i
    dsb = torch.einsum("bthpn,btjhn->btjhp", ds_out, Bt)     # dS_out B_j
    dsx = torch.einsum("bthpn,btjhp->btjhn", ds_out, xt)     # dS_out^T x_j
    dx = (torch.einsum("bthij,btihp->btjhp", M, dyt) + wl[..., None] * dsb
          + D[:, None] * dyt)
    dBh = torch.einsum("bthij,btihn->btjhn", Q, Ct) + wl[..., None] * dsx
    dCh = torch.einsum("bthij,btjhn->btihn", Q, Bt) + ecs[..., None] * U
    v = (xt * dsb).sum(-1)                                   # [b, nt, L, h]
    col_f = Fm.sum(3).transpose(2, 3)                        # sum over i
    row_e = (Fm * dt_j).sum(4).transpose(2, 3)               # sum over j
    dcs = row_e - dtt * col_f + ecs * (Ct * U).sum(-1) - wl * v
    dcs[:, :, -1] += (torch.exp(cs_last) * (ds_out * s_in).sum((-1, -2))
                      + (wl * v).sum(2))
    da = dcs.flip(2).cumsum(2).flip(2)                       # sum over k >= j
    ddt = A * da + col_f + torch.exp(cs_last[:, :, None] - cs) * v
    dA = (dtt * da).sum((0, 1, 2))
    dD = (dyt * xt).sum((0, 1, 2, 4))

    def untile(t):
        return t.reshape(b, nt * tile, *t.shape[3:])[:, :s]

    # dB, dC: each group's heads added in head order
    dBh = untile(dBh).reshape(b, s, g, hg, n)
    dCh = untile(dCh).reshape(b, s, g, hg, n)
    dB, dC = dBh[:, :, :, 0], dCh[:, :, :, 0]
    for k in range(1, hg):
        dB, dC = dB + dBh[:, :, :, k], dC + dCh[:, :, :, k]
    return untile(dx), untile(ddt), dA, dB, dC, dD


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


# ----- the vocab-chunked unembedding and cross-entropy (kernels/unembed_ce.py)

def ce_fold_reference(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                      state: torch.Tensor, lse: torch.Tensor, *, first: bool,
                      last: bool) -> None:
    """``ce_fold_kernel``'s plain version, in place as the kernel: folds
    the chunk ``logits`` [T, w] fp32 (columns ``v0`` .. v0 + w) into
    ``state`` [3, T] (running max, running sum of exp, the label's logit,
    NaN until the label's chunk; ``first`` starts it); ``last`` writes
    each row's log-sum-exp into ``lse`` instead of the running pair."""
    w = logits.shape[1]
    if first:
        state[0] = -math.inf
        state[1] = 0.0
        state[2] = math.nan
    m = torch.maximum(state[0], logits.amax(dim=1))
    s = (state[1] * torch.exp(state[0] - m)
         + torch.exp(logits - m[:, None]).sum(dim=1))
    lab = labels.long() - v0
    hit = (lab >= 0) & (lab < w)
    picked = logits.gather(1, lab.clamp(0, w - 1)[:, None])[:, 0]
    state[2] = torch.where(hit, picked, state[2])
    if last:
        lse.copy_(m + torch.log(s))
    else:
        state[0], state[1] = m, s


def split_planes(g: torch.Tensor) -> torch.Tensor:
    """fp32 ``g`` [T, w] as three bf16 planes [T, 3, w]: hi = bf16(g), mid =
    bf16(g - hi), lo = bf16(g - hi - mid), each rounded to nearest even.
    Their sum is g exactly wherever g's lowest bit lies above bf16's least
    subnormal (2^-133): 8 + 8 + 8 of fp32's 24 significant bits."""
    hi = g.bfloat16()
    r1 = g - hi.float()
    mid = r1.bfloat16()
    lo = (r1 - mid.float()).bfloat16()
    return torch.stack((hi, mid, lo), dim=1)


def ce_grad_reference(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                      lse: torch.Tensor, dce: torch.Tensor, *,
                      planes: torch.Tensor | None = None) -> torch.Tensor:
    """``ce_grad_kernel``'s plain version, in place as the kernel: the
    softmax gradient of the chunk ``logits`` [T, w] fp32 (columns ``v0``
    .. v0 + w) for the mean loss's gradient ``dce``, g = (exp(logits -
    lse) - onehot) * (dce / T), in fp32; with ``planes`` [T, 3, w] bf16
    written there as ``split_planes(g)``, else written over ``logits``.
    Returns what it wrote."""
    rows, w = logits.shape
    cols = torch.arange(v0, v0 + w, device=logits.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    g = (torch.exp(logits - lse[:, None]) - onehot) * (dce.float() / rows)
    if planes is None:
        return logits.copy_(g)
    return planes.copy_(split_planes(g))
