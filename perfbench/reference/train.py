"""The reference's training steps: the gradient of the mean token loss over
a batch, taken in blocks of rows so that it fits, clipped by its global
norm, and AdamW with decoupled weight decay (Loshchilov and Hutter,
arXiv:1711.05101), all in float32. Imports nothing of the program."""

from __future__ import annotations

import torch

from perfbench.reference import architecture
from perfbench.reference.common import Precision, named_leaves


def adamw(params: list, grads: list, mu: list, nu: list, step: int,
          opt: dict) -> None:
    """One AdamW update in place at ``step`` (1 for the first): gradients
    clipped to global norm ``grad_clip``; m and v as Adam's moments; the
    update lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)."""
    b1, b2 = opt["b1"], opt["b2"]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        p.sub_(opt["lr"] * (m_hat / (v_hat.sqrt() + opt["eps"])
                            + opt["weight_decay"] * p))


def grads_of(model, params: dict, tokens: torch.Tensor,
             labels: torch.Tensor, rows: int, half_batch: bool = False):
    """(mean loss, gradients in ``named_leaves`` order) over the batch
    [B, S], ``rows`` rows at a time. ``half_batch`` is a planted fault: the
    mean over the first half of the rows only."""
    leaves = [t for _, t in named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    b = tokens.shape[0] // 2 if half_batch else tokens.shape[0]
    count = b * tokens.shape[1]
    total = 0.0
    for r0 in range(0, b, rows):
        r1 = min(r0 + rows, b)
        loss = model.loss_sum(params, tokens[r0:r1], labels[r0:r1]) / count
        loss.backward()
        total += float(loss.detach())
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves]
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return total, grads


def train_steps(cfg: dict, params: dict, opt_state: dict, batches: list,
                opt: dict, *, rows: int, prec: Precision = Precision(),
                half_batch: bool = False) -> dict:
    """Trains ``params`` (``unstack``'s tree, changed in place) on
    ``batches`` [(tokens, labels)] from ``opt_state`` ({"mu", "nu":
    trees like params, "step": the steps taken}). Returns the losses, the
    first step's clipped gradient's norm by leaf, and the final moments."""
    model = architecture(cfg).Reference(cfg, prec)
    names = [n for n, _ in named_leaves(params)]
    ps = [t for _, t in named_leaves(params)]
    mu = [t for _, t in named_leaves(opt_state["mu"])]
    nu = [t for _, t in named_leaves(opt_state["nu"])]
    step = int(opt_state["step"])
    losses, first_grad = [], None
    with torch.no_grad():
        for tokens, labels in batches:
            with torch.enable_grad():
                loss, grads = grads_of(model, params, tokens, labels, rows,
                                       half_batch)
            losses.append(loss)
            if first_grad is None:
                norm = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-12))
                first_grad = {n: float(torch.linalg.vector_norm(g)) * scale
                              for n, g in zip(names, grads)}
            step += 1
            adamw(ps, grads, mu, nu, step, opt)
            del grads
    return {"losses": losses, "first_grad": first_grad}
