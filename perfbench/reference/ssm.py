"""The plain reference of ``arch_type`` "ssm": the Mamba2 (SSD) language
model, its loss and gradients, in plain PyTorch at float32 (TF32 off),
written from the published description (arXiv:2405.21060) with no kernel,
cache or batching, and importing nothing of the program; its parameter
schema and the model FLOPs of a training step beyond 6 N T.

A Mamba2 layer: h + out_proj(rmsnorm(ssd(conv(x), dt, A, conv(B),
conv(C), D) * silu(z))), with z, x, B, C and dt_raw projections of
rmsnorm(h), depthwise causal convolutions (width 4, with bias) followed by
SiLU on x, B and C, dt = softplus(dt_raw + dt_bias) and A = -exp(A_log).
The SSD scan is computed in its chunked form, which is exact: within a
chunk the masked decay-weighted product, across chunks the carried state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import yardstick
from perfbench.reference.common import FP32, Precision, rms_norm


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal convolution of x [R, S, C] with taps w [W, C] (tap
    W-1 on the current position) and bias b [C], then SiLU."""
    width, ch = w.shape
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))
    y = F.conv1d(xt, w.t().reshape(ch, 1, width), b, groups=ch)
    return F.silu(y.transpose(1, 2))


def ssd_scan(x, dt, A, B, C, D, chunk: int, prec: Precision = FP32):
    """y [R, S, H, P] of the SSD recurrence state_t = exp(dt_t A) state_{t-1}
    + dt_t x_t B_t^T, y_t = state_t C_t + D x_t, from a zero state, in
    chunks of ``chunk``: x [R, S, H, P], dt [R, S, H], A, D [H], B, C
    [R, S, G, N] (heads grouped G ways)."""
    r, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pad = (-s) % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc, L = x.shape[1] // chunk, chunk
    xc = x.reshape(r, nc, L, h, p)
    dtc = dt.reshape(r, nc, L, h)
    # heads of a group share its B and C
    Bh = B.reshape(r, nc, L, g, 1, n).expand(r, nc, L, g, hg, n)
    Ch = C.reshape(r, nc, L, g, 1, n).expand(r, nc, L, g, hg, n)
    Bh = Bh.reshape(r, nc, L, h, n)
    Ch = Ch.reshape(r, nc, L, h, n)
    cs = torch.cumsum(dtc * A, dim=2)                      # [r, nc, L, h]
    xdt = xc * dtc[..., None]                              # [r, nc, L, h, p]
    # within a chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j
    csh = cs.permute(0, 1, 3, 2)                           # [r, nc, h, L]
    diff = csh[..., :, None] - csh[..., None, :]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    Cp, Bp = (t.permute(0, 1, 3, 2, 4) for t in (Ch, Bh))  # [r, nc, h, L, n]
    scores = prec.mm(Cp, Bp.transpose(-1, -2)) * decay     # [r, nc, h, L, L]
    y = prec.mm(scores, xdt.permute(0, 1, 3, 2, 4))        # [r, nc, h, L, p]
    # each chunk's end state, then the states carried across chunks
    to_end = torch.exp(cs[:, :, -1:, :] - cs)              # [r, nc, L, h]
    w = (xdt * to_end[..., None]).permute(0, 1, 3, 4, 2)   # [r, nc, h, p, L]
    ends = prec.mm(w, Bp)                                  # [r, nc, h, p, n]
    chunk_decay = torch.exp(cs[:, :, -1, :])               # [r, nc, h]
    state = torch.zeros(r, h, p, n, device=x.device, dtype=x.dtype)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + ends[:, c]
    starts = torch.stack(starts, dim=1)                    # [r, nc, h, p, n]
    # the carried state's part: exp(cs_i) C_i . start
    y_in = prec.mm(Cp, starts.transpose(-1, -2))           # [r, nc, h, L, p]
    y = y + y_in * torch.exp(csh)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(r, nc * L, h, p)[:, :s]
    return y + x[:, :s] * D[:, None]


class Reference:
    """The model of one configuration (the ``model`` section of its file)
    at a precision."""

    def __init__(self, cfg: dict, prec: Precision = FP32):
        if cfg["arch_type"] != "ssm":
            raise ValueError(f"the reference models arch_type 'ssm', not "
                             f"{cfg['arch_type']!r}")
        self.cfg = cfg
        self.ssm = cfg["ssm"]
        self.prec = prec

    def mamba(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        c, s = self.cfg, self.ssm
        mm = self.prec.mm
        r, sl, _ = h.shape
        a = rms_norm(h, p["norm"], c["norm_eps"])
        z, x, Bm, Cm, dtr = (mm(a, p[n]) for n in (
            "z_proj", "x_proj", "B_proj", "C_proj", "dt_proj"))
        x = causal_conv_silu(x, p["conv_x_w"], p["conv_x_b"])
        Bm = causal_conv_silu(Bm, p["conv_B_w"], p["conv_B_b"])
        Cm = causal_conv_silu(Cm, p["conv_C_w"], p["conv_C_b"])
        dt = F.softplus(dtr + p["dt_bias"])
        g, n, hp = s["ngroups"], s["state_dim"], s["head_dim"]
        y = ssd_scan(x.reshape(r, sl, -1, hp), dt, -torch.exp(p["A_log"]),
                     Bm.reshape(r, sl, g, n), Cm.reshape(r, sl, g, n),
                     p["ssm_D"], s["chunk_size"], self.prec)
        y = y.reshape(r, sl, -1)
        gated = rms_norm(y * F.silu(z), p["gate_norm"], c["norm_eps"])
        return h + mm(gated, p["out_proj"])

    def loss_sum(self, params: dict, tokens: torch.Tensor,
                 labels: torch.Tensor, remat: bool = True) -> torch.Tensor:
        """The sum over positions of -log softmax(logits)[label] for
        tokens, labels [R, S]; each block recomputed in the backward pass
        when ``remat``, to fit."""
        h = params["embed"][tokens.long()]
        for p in params["layers"]:
            h = (checkpoint(self.mamba, p, h, use_reentrant=False) if remat
                 else self.mamba(p, h))
        h = rms_norm(h, params["final_norm"], self.cfg["norm_eps"])
        logits = self.prec.mm(h, params["lm_head"])
        return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(),
                               reduction="sum")


def a_log(u: torch.Tensor) -> torch.Tensor:
    """A_log from U(0, 1) draws: the log of U(1, 16)."""
    return torch.log(1.0 + 15.0 * u)


def dt_bias(u: torch.Tensor) -> torch.Tensor:
    """dt_bias from U(0, 1) draws: the inverse softplus of a log-uniform dt
    in [1e-3, 1e-1]."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * u)
    return dt + torch.log(-torch.expm1(-dt))


def schema(cfg: dict) -> dict:
    """{path: (shape, init)} of the parameters in the program's layout and
    names (stacked [L, ...] layer leaves), sorted by path, initialised as
    Mamba2 does (``generator.schema`` gives the inits' forms)."""
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    s = cfg["ssm"]
    di = s["expand"] * d
    h = di // s["head_dim"]
    gn = s["ngroups"] * s["state_dim"]
    w = s["conv_width"]
    normal, out = ("normal", 0.02), ("normal", 0.02 / math.sqrt(2 * n))
    leaves = {
        "embed": ((v, d), normal), "final_norm": ((d,), ("ones",)),
        "lm_head": ((d, v), normal),
        "layers.norm": ((n, d), ("ones",)),
        "layers.z_proj": ((n, d, di), normal),
        "layers.x_proj": ((n, d, di), normal),
        "layers.B_proj": ((n, d, gn), normal),
        "layers.C_proj": ((n, d, gn), normal),
        "layers.dt_proj": ((n, d, h), normal),
        "layers.conv_x_w": ((n, w, di), ("normal", 0.2)),
        "layers.conv_x_b": ((n, di), ("zeros",)),
        "layers.conv_B_w": ((n, w, gn), ("normal", 0.2)),
        "layers.conv_B_b": ((n, gn), ("zeros",)),
        "layers.conv_C_w": ((n, w, gn), ("normal", 0.2)),
        "layers.conv_C_b": ((n, gn), ("zeros",)),
        "layers.A_log": ((n, h), ("uniform", a_log)),
        "layers.ssm_D": ((n, h), ("ones",)),
        "layers.dt_bias": ((n, h), ("uniform", dt_bias)),
        "layers.gate_norm": ((n, di), ("ones",)),
        "layers.out_proj": ((n, di, d), out),
    }
    return dict(sorted(leaves.items()))


def step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step beyond 6 N T: the SSD scan's
    forward and backward at every Mamba2 layer."""
    s = cfg["ssm"]
    h = s["expand"] * cfg["d_model"] // s["head_dim"]
    shape = (batch, seq, h, s["head_dim"], s["ngroups"], s["state_dim"])
    return cfg["num_layers"] * (yardstick.ssd_fwd_cost(*shape)[0]
                                + yardstick.ssd_bwd_cost(*shape)[0])
