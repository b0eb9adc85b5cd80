"""What the benchmark makes from ``--seed``: the weights and optimizer
state, drawn on the device in a few large calls, and the token batches,
from one general generator whose parameters the traffic file gives.

The token stream is a copy of the program's synthetic stream
(``repro_torch/data/synthetic.py``): a Zipf marginal over the vocabulary
with, at probability ``repeat_p``, the next token a fixed function of the
previous one. It is copied so that the benchmark's inputs do not move with
the program; the resume cell's loop draws the same rows from the program's
own stream, and the reference draws them from this copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import architecture


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``'s draws, from the run's seed."""
    words = [int(b) for b in tag.encode()]
    seq = np.random.SeedSequence([seed & ((1 << 64) - 1), *words])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


class TokenStream:
    """Rows of ``seq_len + 1`` tokens, a function of (seed, step) alone."""

    def __init__(self, vocab_size: int, seed: int, zipf_a: float = 1.2,
                 repeat_p: float = 0.5):
        self.vocab_size = vocab_size
        self.seed = seed
        self.repeat_p = repeat_p
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        pmf = ranks ** (-zipf_a)
        self._pmf = pmf / pmf.sum()

    def rows(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        n = batch * (seq_len + 1)
        iid = rng.choice(self.vocab_size, size=n, p=self._pmf)
        use_prev = rng.random(n) < self.repeat_p
        prev = np.roll(iid, 1)
        out = np.where(use_prev, (3 * prev + 7) % self.vocab_size, iid)
        return out.reshape(batch, seq_len + 1).astype(np.int32)

    def batch(self, step: int, batch: int, seq_len: int, device) -> tuple:
        """(tokens, labels) [batch, seq_len] int32 on ``device``."""
        raw = torch.from_numpy(self.rows(step, batch, seq_len)).to(device)
        return raw[:, :-1], raw[:, 1:]


def stream_for(cfg: dict, traffic: dict, seed: int) -> TokenStream:
    return TokenStream(cfg["vocab_size"], stream_seed(seed),
                       **traffic.get("stream", {}))


def stream_seed(seed: int) -> int:
    return derived_seed(seed, "tokens")


def schema(cfg: dict) -> dict:
    """{path: (shape, init)} of the parameters in the program's layout and
    names (stacked [L, ...] layer leaves), sorted by path, from the module
    of the configuration's architecture. ``init`` is ("normal", std),
    ("ones",), ("zeros",) or ("uniform", fn): ``fn`` of U(0, 1) draws."""
    return architecture(cfg).schema(cfg)


def nest(flat: dict) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _draws(shapes: list, kind: str, gen: torch.Generator, device):
    """One draw over every leaf in ``shapes``, split into them."""
    total = sum(math.prod(s) for s in shapes)
    flat = (torch.randn if kind == "normal" else torch.rand)(
        total, generator=gen, device=device)
    out, at = [], 0
    for s in shapes:
        k = math.prod(s)
        out.append(flat[at:at + k].view(s))
        at += k
    return out


def weights(cfg: dict, seed: int, device) -> dict:
    """The float32 parameters drawn from ``seed`` on ``device``: two draws
    (one normal over every normal leaf, one uniform over the rest), each
    leaf then a tensor of its own."""
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, "weights"))
    sch = schema(cfg)
    normal = [p for p, (_, init) in sch.items() if init[0] == "normal"]
    uniform = [p for p, (_, init) in sch.items() if init[0] == "uniform"]
    drawn = dict(zip(normal, _draws([sch[p][0] for p in normal], "normal",
                                    gen, device)))
    drawn.update(zip(uniform, _draws([sch[p][0] for p in uniform],
                                     "uniform", gen, device)))
    out = {}
    for path, (shape, init) in sch.items():
        kind = init[0]
        if kind == "normal":
            t = drawn[path] * init[1]
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = init[1](drawn[path])
        out[path] = t
    del drawn
    return nest(out)


def moments(cfg: dict, seed: int, device, mu_std: float,
            nu_scale: float, nu: bool = True) -> tuple[dict, dict | None]:
    """AdamW moments of a run in progress, drawn from ``seed``: mu ~
    N(0, mu_std^2), nu = nu_scale^2 * (0.5 + U(0, 1)), by leaf as
    ``schema``; without ``nu`` the same mu alone (nu is drawn after it)."""
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, "moments"))
    sch = schema(cfg)
    shapes = [shape for shape, _ in sch.values()]
    mus = nest({p: t * mu_std for p, t in
                zip(sch, _draws(shapes, "normal", gen, device))})
    if not nu:
        return mus, None
    nus = {p: (t + 0.5) * nu_scale ** 2 for p, t in
           zip(sch, _draws(shapes, "uniform", gen, device))}
    return mus, nest(nus)


def count_params(cfg: dict) -> int:
    """Parameters outside the embedding table."""
    return sum(math.prod(s) for p, (s, _) in schema(cfg).items()
               if p != "embed")
