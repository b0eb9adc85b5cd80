"""The train step: loss -> grad -> clip -> AdamW, the JAX package's
``train/step.py`` without jit, on one device or on a mesh.

The gradient goes through ``torch.autograd`` into one stacked gradient
buffer per parameter leaf. The model sees per-layer leaf views of the
stacked masters (``params["layers"][name][i]``), each with its ``.grad``
preset to the matching view of the stacked buffer, so autograd's
accumulation adds each layer's gradient in place. Slicing the stacked
masters under autograd instead (``t[i]`` of a leaf that requires grad)
would make every layer's ``select`` backward allocate a zero tensor of the
whole stacked leaf and add it in: 36 memsets and adds over ~11 GB of
qwen2.5-3b's layer masters per step, and a 3.25 GB transient.

On a mesh (``Model(cfg, make_rules(mesh))``) the parameters, the gradient
buffers and the views are DTensors with the parameters' placements. A
view's gradient arrives with the placements autograd gives it (a partial
sum across ranks where the island or product says so); a hook redistributes
it to the parameter's placements as it arrives (a reduce-scatter or an
all-reduce) and adds it into the buffer, so a block used more than once
sums every use. AdamW then updates the DTensors in place and ``grad_norm``
reduces across ranks.

A step's spans (``repro_torch.core.profiler.span``): ``step``, the root,
and inside it ``step.prepare`` (the zeroed gradient tree and the views),
``step.forward``, ``step.backward`` and ``step.optimizer`` (the lr,
clip and AdamW).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.profiler import span
from repro_torch.models.model import Model
from repro_torch.models.sharded import view_of
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_map)


@dataclass
class TrainState:
    params: Any
    opt: dict
    step: int = 0


def _leaf_view(t: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    if isinstance(t, DTensor):
        return _dtensor_leaf_view(t, grad)
    view = t.detach().requires_grad_()
    view.grad = grad
    return view


def _dtensor_leaf_view(t: DTensor, grad: DTensor) -> DTensor:
    """A leaf DTensor of ``t``'s storage whose every gradient is added, in
    ``grad``'s placements, into ``grad``'s local storage."""
    view = t.detach().requires_grad_()

    def add(v):
        g = v.grad
        if tuple(g.placements) != tuple(grad.placements):
            g = g.redistribute(grad.device_mesh, grad.placements)
        grad.to_local().add_(g.to_local())
        v.grad = None

    view.register_post_accumulate_grad_hook(add)
    return view


def _leaf_views(tree, grads):
    """``_leaf_view`` over a tree of dicts: a block used more than once
    (the hybrid family's ``shared_attn``) adds every use's gradient into
    the one buffer."""
    if isinstance(tree, dict):
        return {name: _leaf_views(t, grads[name]) for name, t in tree.items()}
    return _leaf_view(tree, grads)


def model_views(model: Model, params: dict, grads: dict) -> dict:
    """The tree the model trains on: leaf views of ``params``, the stacked
    layer leaves as per-layer views, each view's gradient added into
    ``grads`` (a zeroed tree shaped like ``params``) in place."""
    views = {name: _leaf_views(t, grads[name])
             for name, t in params.items() if name != "layers"}
    stacked, stacked_grads = params["layers"], grads["layers"]
    views["layers"] = [
        {name: _leaf_view(_layer(t, i), _layer(stacked_grads[name], i))
         for name, t in stacked.items()}
        for i in range(model.cfg.num_layers)]
    return views


def backprop(model: Model, views: dict, batch: dict):
    """``model.train_loss(views, batch)`` and its backward into the views'
    gradient buffers. Returns (loss, metrics), detached."""
    with span("step.forward"):
        loss, metrics = model.train_loss(views, batch)
    with span("step.backward"):
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def loss_and_grads(model: Model, params: dict, batch: dict, grads: dict):
    """``model.train_loss(params, batch)`` and its gradient, accumulated
    into ``grads`` (a zeroed tree shaped like ``params``) in place. Returns
    (loss, metrics), detached."""
    return backprop(model, model_views(model, params, grads), batch)


def _layer(t: torch.Tensor, i: int) -> torch.Tensor:
    return view_of(t, i) if isinstance(t, DTensor) else t[i]


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_fn: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with the metrics ``loss``, ``ce``, ``aux``, ``lr`` and
    ``grad_norm`` as 0-d tensors. It updates ``params`` and ``opt_state``
    in place and returns the same objects. The gradient buffers live for
    one step."""

    def train_step(params, opt_state, batch):
        with span("step"):
            with span("step.prepare"):
                grads = tree_map(torch.zeros_like, params)
                views = model_views(model, params, grads)
            loss, metrics = backprop(model, views, batch)
            del views
            with span("step.optimizer"):
                lr = lr_fn(opt_state["step"]) if lr_fn is not None \
                    else opt_cfg.lr
                with implicit_replication():
                    params, opt_state, opt_metrics = adamw_update(
                        params, grads, opt_state, opt_cfg, lr=lr)
                if isinstance(opt_metrics["grad_norm"], DTensor):
                    opt_metrics["grad_norm"] = \
                        opt_metrics["grad_norm"].full_tensor()
            del grads
            metrics = dict(metrics, loss=loss,
                           lr=torch.as_tensor(lr, dtype=torch.float32),
                           **opt_metrics)
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    """fp32 master parameters (``cfg.param_dtype``) and zero AdamW state."""
    params = model.init(generator, dtype=getattr(torch, model.cfg.param_dtype))
    return TrainState(params=params, opt=adamw_init(params))
