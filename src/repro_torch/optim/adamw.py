"""AdamW with decoupled weight decay and global-norm gradient clipping: the
JAX package's ``optim/adamw.py`` over the same parameter-congruent trees
(nested dicts of tensors), with its defaults and its order of operations.

Unlike the reference's pure functions, the update works in place under
``torch.no_grad``: the gradients are scaled, ``mu``, ``nu`` and the
parameters are overwritten and ``step`` is incremented, with one temporary
at a time, of one leaf's size. The reference's leaf-wise functional form
makes about seven; on qwen2.5-3b's stacked ``w_gate`` (36 x 2048 x 11008
in fp32, 3.25 GB) that is ~23 GB on top of the 54 GB training state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, keys in sorted
    order (as ``jax.tree.leaves`` flattens a dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def adamw_init(params) -> dict:
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(square(leaf)) in fp32, as a 0-d
    tensor; each leaf's sum of squares is taken without a temporary."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
          for t in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place by min(1, max_norm / norm); returns
    (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr: torch.Tensor | float | None = None):
    """One AdamW step, in place: clip, step + 1, the bias corrections
    1 - b^step in fp32, delta = mu_hat / (sqrt(nu_hat) + eps), then
    p - lr * (delta + wd * p). Returns (params, state, {"grad_norm"}), the
    same objects as given."""
    if lr is None:
        lr = cfg.lr
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"]
    step.add_(1)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g32 = g.float()
        mu.mul_(b1).add_(g32, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        t = torch.div(nu, bc2)              # nu_hat
        t.sqrt_().add_(cfg.eps)
        torch.div(mu, t, out=t)
        t.div_(bc1)                         # delta = mu_hat / (sqrt + eps)
        p32 = p if p.dtype == torch.float32 else p.float()
        t.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        if p32 is p:
            p.sub_(t)
        else:
            p.copy_(p32 - t)
        del t
    return params, state, {"grad_norm": gnorm}
