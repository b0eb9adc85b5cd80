"""The train step: loss -> grad -> clip -> AdamW, the JAX package's
``train/step.py`` without jit and without sharding specs (one device;
sharding is ROADMAP A.8).

The gradient goes through ``torch.autograd`` into one stacked gradient
buffer per parameter leaf. The model sees per-layer leaf views of the
stacked masters (``params["layers"][name][i]``), each with its ``.grad``
preset to the matching view of the stacked buffer, so autograd's
accumulation adds each layer's gradient in place. Slicing the stacked
masters under autograd instead (``t[i]`` of a leaf that requires grad)
would make every layer's ``select`` backward allocate a zero tensor of the
whole stacked leaf and add it in: 36 memsets and adds over ~11 GB of
qwen2.5-3b's layer masters per step, and a 3.25 GB transient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_map)


@dataclass
class TrainState:
    params: Any
    opt: dict
    step: int = 0


def _leaf_view(t: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    view = t.detach().requires_grad_()
    view.grad = grad
    return view


def loss_and_grads(model: Model, params: dict, batch: dict, grads: dict):
    """``model.train_loss(params, batch)`` and its gradient, accumulated
    into ``grads`` (a zeroed tree shaped like ``params``) in place. Returns
    (loss, metrics), detached."""
    views = {name: _leaf_view(t, grads[name])
             for name, t in params.items() if name != "layers"}
    stacked, stacked_grads = params["layers"], grads["layers"]
    views["layers"] = [
        {name: _leaf_view(t[i], stacked_grads[name][i])
         for name, t in stacked.items()}
        for i in range(model.cfg.num_layers)]
    loss, metrics = model.train_loss(views, batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_fn: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with the metrics ``loss``, ``ce``, ``aux``, ``lr`` and
    ``grad_norm`` as 0-d tensors. It updates ``params`` and ``opt_state``
    in place and returns the same objects. The gradient buffers live for
    one step."""

    def train_step(params, opt_state, batch):
        grads = tree_map(torch.zeros_like, params)
        loss, metrics = loss_and_grads(model, params, batch, grads)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else opt_cfg.lr
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, lr=lr)
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
