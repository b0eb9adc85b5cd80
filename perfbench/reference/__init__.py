"""The plain reference: plain PyTorch at float32, importing nothing of the
program. One module an architecture, ``<arch_type>.py``, is all the code
that knows it, and exports

    Reference(cfg, prec)        the model; ``loss_sum(params, tokens,
                                labels, remat=True)``
    schema(cfg)                 {path: (shape, init)} of its parameters
    step_flops(cfg, batch, seq) model FLOPs of a training step beyond 6 N T

``common.py`` holds what they share; ``train.py`` the training steps.
"""

import importlib
from pathlib import Path

from perfbench.harness import RunError

HERE = Path(__file__).resolve().parent


def architecture(cfg: dict):
    """The module of ``cfg``'s ``arch_type``, from
    ``perfbench/reference/<arch_type>.py``."""
    name = cfg["arch_type"]
    path = HERE / f"{name}.py"
    if not (name.isidentifier() and path.is_file()):
        raise RunError(f"arch_type {name!r} has no reference at {path}")
    return importlib.import_module(f"{__name__}.{name}")
