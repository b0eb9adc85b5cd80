"""What every architecture's reference shares: the precision of the matrix
products, the tree helpers and RMSNorm, in plain PyTorch, importing nothing
of the program.

Parameters are a tree of float32 tensors under the names the program's
training step takes (``embed`` [V, D], ``final_norm`` [D], ``lm_head``
[D, V], ``layers`` {name: [L, ...]}), all in ``x @ W`` orientation. A
reference holds the layers as a list of per-layer dicts (``unstack``), so
that each layer's gradient lands in a tensor of its own.

``Precision`` rounds the operands of every matrix product: ``"fp32"`` is
the reference; ``"fp8"``, each operand scaled to the e4m3 range by its
largest magnitude and rounded (the gradient passes straight through), is
the control that a comparison has to reject.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@dataclass(frozen=True)
class Precision:
    operands: str = "fp32"   # "fp32" or "fp8"

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.operands == "fp32":
            return t
        if self.operands != "fp8":
            raise ValueError(f"Precision: operands {self.operands!r}")
        scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (q - t.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


FP32 = Precision()


def unstack(params: dict) -> dict:
    """The tree with ``layers`` as a list of per-layer dicts of float32
    copies, each a leaf of its own."""
    out = {k: _copy(v) for k, v in params.items() if k != "layers"}
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    out["layers"] = [{name: t[i].detach().float().clone()
                      for name, t in stacked.items()} for i in range(n)]
    return out


def _copy(tree):
    return map_tree(lambda t: t.detach().float().clone(), tree)


def map_tree(fn, tree):
    """``fn`` over the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def named_leaves(tree: dict, prefix: str = "") -> list:
    """(name, tensor) of every leaf, per layer for a list of layers:
    ``layers.x_proj[3]``, ``embed``; names sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += named_leaves(v, name + ".")
        elif isinstance(v, list):
            for i, layer in enumerate(v):
                out += [(f"{name}.{n}[{i}]", t) for n, t in
                        sorted(layer.items())]
        else:
            out.append((name, v))
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale
