"""The MoE family's training path against the JAX package's: the cases of
tests/test_torch_moe.py (tiny moonshot-v1-16b-a3b, mixtral-8x22b and
dbrx-132b, a narrow moonshot with its real 64 experts, top 6, and a dense
config with ``moe=MoEConfig(4, 2)``, each at ``capacity_factor`` 8.0 and at
the default): ``train_loss`` (ce, the layers' mean load-balance aux and
their weighted sum), every gradient leaf (``router`` among them) in fp32
and bf16, one train step, and remat, whose recomputed layers must route
exactly as the forward did.

The reference runs on an Auto-axis (1, 1) mesh under ``jax.jit``. Inputs
are the synthetic stream's. Tolerances: fp32 to 2e-4 of each leaf's
largest entry; bf16 to 4e-2 by each leaf's relative L2 error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticStream as JStream
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_moe import (CASES, CFS, Routes, _rel, flipped_tokens,  # noqa: F401
                            jax_rules, pairs)
from test_torch_train import _close_leaf, _leaves

FP32_TOL = 2e-4
BF16_TOL = 4e-2
B, S = 2, 48


def _batch(vocab: int, step: int = 0):
    raw = JStream(vocab, 0).batch(step, B, S)
    return ({"tokens": jnp.asarray(raw[:, :-1]),
             "labels": jnp.asarray(raw[:, 1:])},
            {"tokens": torch.from_numpy(raw[:, :-1].copy()),
             "labels": torch.from_numpy(raw[:, 1:].copy())})


def _port_grads(m, tp, batch):
    grads = adamw.tree_map(torch.zeros_like, tp)
    loss, metrics = loss_and_grads(m, tp, batch, grads)
    return loss, metrics, grads


@pytest.mark.parametrize("cf", CFS, ids=["cf8", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_match_reference_fp32(pairs, case, cf):
    jm, jp, m, tp = pairs(case, cf=cf)
    jb, tb = _batch(m.cfg.vocab_size)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    loss, met, grads = _port_grads(m, tp, tb)
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=FP32_TOL)
    # loss = ce + w * aux, the aux the layers' mean, about 1 when balanced
    assert 0.5 < met["aux"].item() < 4
    torch.testing.assert_close(
        loss, met["ce"] + m.cfg.moe.router_aux_weight * met["aux"])
    names = [name for name, _, _ in _leaves(jgrads, grads)]
    assert "layers/router" in names and "layers/w_down" in names
    for name, j, t in _leaves(jgrads, grads):
        assert tuple(t.shape) == j.shape, name
        _close_leaf(name, j, t, FP32_TOL)
    assert torch.count_nonzero(grads["layers"]["router"]) > 0


def force_routes(monkeypatch, idx_by_layer: list) -> None:
    """Routes the port's MoE layers to the given expert ids [T, k], layer
    by layer (remat's backward recomputes the last layer first), with the
    gates renormalised from its own probabilities at those experts."""
    n, calls = len(idx_by_layer), []
    inner = moe.router_topk

    def forced(x32, router_w, k):
        probs, _, _ = inner(x32, router_w, k)
        c = len(calls)
        calls.append(c)
        idx = torch.from_numpy(idx_by_layer[c if c < n else 2 * n - 1 - c])
        gate = probs.gather(1, idx.long())
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                         min=1e-9), idx.long()

    monkeypatch.setattr(moe, "router_topk", forced)


@pytest.mark.parametrize("cf", CFS, ids=["cf8", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_match_reference_bf16(pairs, monkeypatch,
                                                   case, cf):
    """bf16 compute over fp32 masters on both sides. bf16 rounds in other
    places in the two packages, so a token at a near-tie may take another
    expert (``flipped_tokens`` holds each to FLIP_MARGIN): 1-3 of these 96
    tokens with 64 experts, top 6, or the dense config's 4, top 2. Such a
    token's gradient moves by O(1), not by rounding, and a leaf that sums
    few tokens (``mlp_norm``) by ~1/sqrt(T) of itself. So the loss is held
    to 4e-2 as routed, and the gradients as routed where nothing flipped;
    then the port is routed as the reference was (``force_routes``) and
    every gradient leaf is held to 4e-2."""
    jm, jp, m, tp = pairs(case, "bfloat16", cf)
    jb, tb = _batch(m.cfg.vocab_size, step=1)
    layers = m.cfg.num_layers
    jr, tr = Routes(monkeypatch, reference=True), Routes(monkeypatch)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    jax.block_until_ready(jloss)
    loss, met, grads = _port_grads(m, tp, tb)
    # the forward's calls come first (then remat's recomputation)
    assert len(tr.calls) == 2 * layers and len(jr.calls) >= layers
    flips = flipped_tokens(jr.calls[:layers], tr.calls[:layers],
                           m.cfg.moe.experts_per_token)
    print(f"{case} cf={cf}: {int(flips.sum())} of {flips.size} tokens "
          f"routed apart")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=BF16_TOL)
    if not flips.any():
        for name, j, t in _leaves(jgrads, grads):
            assert _rel(j, t) <= BF16_TOL, name
    force_routes(monkeypatch, [idx for _, idx in jr.calls[:layers]])
    loss, met, grads = _port_grads(m, tp, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)
    for name, j, t in _leaves(jgrads, grads):
        assert _rel(j, t) <= BF16_TOL, name


@pytest.mark.parametrize("cf", CFS, ids=["cf8", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(pairs, case, cf):
    """One step of make_train_step: the metrics, mu and nu to 2e-4; the
    parameters by their move, as Adam makes it (tests/test_torch_hybrid.py):
    each leaf's move to 1e-2 by its relative L2 error, each element to
    2e-4 of the leaf's largest entry or a tenth of the learning rate, or
    where its mu cannot be told from zero at 2e-4, twice the rate."""
    jm, jp, m, tp = pairs(case, cf=cf)
    tp = adamw.tree_map(torch.clone, tp)
    jb, tb = _batch(m.cfg.vocab_size, step=2)
    j1, js, jmet = jax.jit(jmake_train_step(jm, jadamw.AdamWConfig()))(
        jp, jadamw.adamw_init(jp), jb)
    t1, ts, tmet = make_train_step(m, adamw.AdamWConfig())(
        adamw.tree_map(torch.clone, tp), adamw.adamw_init(tp), tb)
    assert set(tmet) == set(jmet)
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=FP32_TOL, atol=1e-7, err_msg=key)
    assert tmet["aux"].item() > 0
    for part in ("mu", "nu"):
        for name, j, t in _leaves(js[part], ts[part]):
            _close_leaf(f"{part}/{name}", j, t, FP32_TOL)
    moved = float(tmet["lr"])
    for (name, j, t), (_, j_0, t_0), (_, mu, _) in zip(
            _leaves(j1, t1), _leaves(jp, tp), _leaves(js["mu"], ts["mu"])):
        j, j_0, mu = np.asarray(j), np.asarray(j_0), np.abs(np.asarray(mu))
        assert not torch.equal(t, t_0), name
        assert _rel(j - j_0, t - t_0) <= 1e-2, name
        zero = mu <= FP32_TOL * mu.max()
        atol = np.maximum(FP32_TOL * np.abs(j).max(),
                          np.where(zero, 2 * moved, 0.1 * moved))
        err = np.abs(t.numpy() - j)
        assert np.all(err <= atol + FP32_TOL * np.abs(j)), (name, err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_routes_as_the_forward_and_gives_the_same_gradients(
        pairs, monkeypatch, case, dtype):
    """Each layer's recomputation routes every token to the same experts
    as its forward did (the routing is a function of the layer's inputs),
    and the gradients with and without remat are the same bits, under
    deterministic algorithms (the CPU's gather backward otherwise sums in
    a varying order), at the default capacity factor, drops included."""
    _, _, m, tp = pairs(case, dtype)
    _, tb = _batch(m.cfg.vocab_size, step=3)
    assert m.remat
    plain = Model(m.cfg, device="cpu", remat=False)
    routes = Routes(monkeypatch)
    torch.use_deterministic_algorithms(True)
    try:
        loss, met, grads = _port_grads(m, tp, tb)
        n = len(routes.calls)
        loss2, met2, grads2 = _port_grads(plain, tp, tb)
    finally:
        torch.use_deterministic_algorithms(False)
    layers = m.cfg.num_layers
    assert n == 2 * layers and len(routes.calls) == 3 * layers
    fwd, recompute, plain_fwd = (routes.calls[i * layers:(i + 1) * layers]
                                 for i in range(3))
    recompute = recompute[::-1]       # the backward meets the last first
    for (p1, i1), (p2, i2), (p3, i3) in zip(fwd, recompute, plain_fwd):
        assert np.array_equal(i1, i2) and np.array_equal(i1, i3)
        assert np.array_equal(p1, p2)
    assert loss.item() == loss2.item()
    assert met["aux"].item() == met2["aux"].item()
    for t, t2 in zip(adamw.tree_leaves(grads), adamw.tree_leaves(grads2)):
        assert torch.equal(t, t2)

