"""Roofline pruning for the autotune sweep.

Measuring a candidate costs a launch, a plain-version check and timed
repeats; pricing it costs arithmetic on its shapes. So the sweep prices
every candidate with the H100 roofline (``repro_torch.roofline``: the
kernels' ``(flops, bytes, grid_steps)`` from ``kernel_cost``, the card's
peak rates from ``analysis``), and only the cheapest-predicted few reach
measurement. The default config always reaches it
(``repro_torch.tune.autotune._sweep``).

The prediction is a *ranking* signal, not a latency estimate: a serial
step of a kernel costs it a fixed latency however little it computes, so
configs with the same FLOPs and bytes still part by their steps, which is
all pruning needs. Nothing here launches a kernel.
"""

from __future__ import annotations

from repro_torch.roofline import kernel_cost
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS

# fixed latency of one serial grid step (a block's wait on a barrier, a
# pipeline's fill): the term that separates block configs whose flop/byte
# totals are identical
LAUNCH_OVERHEAD_S = 1e-6

_COSTS = {"flash_attention": kernel_cost.flash_cost,
          "ssd": kernel_cost.ssd_cost}


def predict_seconds(kernel: str, config: dict, **shape) -> float:
    """Roofline-predicted seconds for ``kernel`` ("flash_attention" or
    "ssd") at ``config`` on ``shape`` (``kernel_cost``'s arguments): the
    sum over its grid steps of each step's FLOPs at the peak rate, its
    bytes at the memory rate and ``LAUNCH_OVERHEAD_S``."""
    flops, nbytes, steps = _COSTS[kernel](**shape, **config)
    return steps * (flops / PEAK_FLOPS + nbytes / HBM_BW + LAUNCH_OVERHEAD_S)


def prune_candidates(candidates: list, predict, keep: int) -> list:
    """Rank ``candidates`` by ``predict(candidate)`` ascending and keep
    the best ``keep``.  Returns ``[(candidate, predicted_s), ...]``; a
    candidate whose trace fails is dropped (it would fail measurement
    too, just slower)."""
    priced = []
    for cand in candidates:
        try:
            priced.append((cand, predict(cand)))
        except Exception:  # noqa: BLE001 - unlowerable candidate
            continue
    priced.sort(key=lambda cp: cp[1])
    return priced[:max(1, int(keep))]
