"""The comparison that decides ``correct``: the program's training steps
against the plain reference's, started from the same weights and state and
fed the same rows.

The numbers; each cell compares those its file under
``perfbench/limits/`` gives a limit:

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the compared steps; ``first_loss_gap``: the first step's;
* ``grad_gap``: over the leaves (each layer's slice of a stacked leaf is
  a leaf), the largest gap between the norm of the first step's clipped
  gradient and the reference's, |a - r| / max(r, the median leaf's r);
* ``update_gap``: the same gap between the norms of each leaf's change
  over the compared steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (those below move under AdamW
  by round-off alone).

A number that is not finite, or a leaf missing on one side, fails.
"""

from __future__ import annotations

import math
import statistics

import torch

GRAD_FLOOR = 1e-3   # of the median leaf's reference gradient norm


def device_norms(tree: dict, minus: dict | None = None,
                 minus_scale: float = 1.0, scale: float = 1.0) -> dict:
    """{leaf name: 0-d device tensor}: the norm of each leaf of a program
    tree (stacked ``layers``), each layer's slice its own leaf, named as
    ``reference.common.named_leaves`` names them; of ``tree - minus_scale *
    minus`` when ``minus`` is given. Nothing waits for the device."""
    out = {}

    def norm(v, o, rows):
        t = v.float()
        if o is not None:
            t = t - minus_scale * o.float()
        return torch.linalg.vector_norm(t.reshape(rows, -1), dim=1) * scale

    def walk(node, other, prefix):
        for k in sorted(node):
            v, o = node[k], (other[k] if other is not None else None)
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, o, name + ".")
            elif prefix == "layers.":
                n = norm(v, o, v.shape[0])
                for i in range(v.shape[0]):
                    out[f"layers.{k}[{i}]"] = n[i]
            else:
                out[name] = norm(v, o, 1)[0]

    walk(tree, minus, "")
    return out


def stacked_norms(tree: dict, minus: dict | None = None,
                  scale: float = 1.0) -> dict:
    """``device_norms`` as floats."""
    norms = device_norms(tree, minus, scale=scale)
    values = torch.stack(list(norms.values())).tolist() if norms else []
    return dict(zip(norms, values))


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    if set(got) != set(want):
        return math.inf
    names = [n for n in want if keep is None or keep(n)]
    if not names:
        return math.inf
    floor = statistics.median(want[n] for n in want)
    gaps = [abs(got[n] - want[n]) / max(want[n], floor, 1e-30)
            for n in names]
    return max(gaps)


def worst_leaves(program: dict, reference: dict, key: str, k: int = 3):
    """The ``k`` leaves with the largest gaps in ``key`` ("first_grad" or
    "update"), as (name, gap, reference norm): for reading a number."""
    want, got = reference[key], program[key]
    floor = statistics.median(want.values())
    gaps = [(abs(got[n] - want[n]) / max(want[n], floor, 1e-30), n, want[n])
            for n in want if n in got]
    return [(n, g, w) for g, n, w in sorted(gaps, reverse=True)[:k]]


# the leaf readings and the numbers their gaps give
LEAF_NUMBERS = {"first_grad": "grad_gap", "update": "update_gap"}


def numbers(program: dict, reference: dict) -> dict:
    """The compared numbers from each side's readings: ``losses`` (per
    step) give ``loss_gap`` over every step and ``first_loss_gap`` over
    the first; each of ``LEAF_NUMBERS``' readings ({leaf: norm}) that
    both sides have gives its gap, ``update_gap`` over the leaves whose
    reference gradient (``first_grad``) is not nought to rounding."""
    pl, rl = program["losses"], reference["losses"]
    out = {"loss_gap": math.inf, "first_loss_gap": math.inf}
    if len(pl) == len(rl) and pl:
        gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, rl)]
        out.update(loss_gap=max(gaps), first_loss_gap=gaps[0])
    grads = reference["first_grad"]
    floor = statistics.median(grads.values()) * GRAD_FLOOR
    for key, name in LEAF_NUMBERS.items():
        if key in program and key in reference:
            keep = (lambda n: grads[n] >= floor) if key == "update" else None
            out[name] = _leaf_gap(program[key], reference[key], keep)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each finite and at most its limit; a number the run
    could not read, or one with no limit, fails."""
    shown = {k: {"value": nums.get(k, math.inf), "limit": lim}
             for k, lim in limits.items()}
    ok = all(c["limit"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in shown.values())
    return ok, shown
