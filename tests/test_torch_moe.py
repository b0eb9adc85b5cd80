"""The port's MoE block (``repro_torch.models.moe``) and the MoE family's
serving path against the JAX package's ``models/moe.py`` and ``Model``.

Units: ``router_topk`` (planted ties go to the lower expert, as
``jax.lax.top_k``'s), ``load_balance_aux``, ``capacity_for``,
``_dispatch_indices`` (drops; a stable order among equal experts), and the
block, forward and gradients, against ``make_sharded_moe`` on the (1, 1)
mesh (``moe_block_local`` alone needs the mesh's axis context).

Whole model: tiny moonshot-v1-16b-a3b (4 experts, top 2), tiny
mixtral-8x22b (a window of 64 below the prompts of 80, so that the ring
wraps), tiny dbrx-132b, a narrow moonshot with its real 64 experts, top 6
(a decode step at B = 2 has capacity 1 and drops), and a dense config
with ``moe=MoEConfig(4, 2)``; each at ``capacity_factor`` 8.0 (nothing
dropped) and at the default 1.25 (drops, counted): prefill's logits and
every cache leaf, then three ``decode_step``s, in fp32 and in bf16.

The reference runs on an Auto-axis (1, 1) mesh under ``jax.jit``, as in
tests/test_torch_hybrid.py. Inputs are made from a seed with numpy.
Tolerances are the repo's: fp32 to 2e-4 of each leaf's largest entry,
bf16 to 4e-2 by each leaf's relative L2 error. The bf16 cases also count
the tokens whose expert set differs between the packages (bf16 rounds in
other places in each, so a token whose k-th and (k+1)-th probabilities
nearly tie may route apart); these inputs route alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import KV_CACHE, Model
from test_torch_train import _close_leaf

FP32_TOL = 2e-4
BF16_TOL = 4e-2
S, CACHE_LEN = 80, 96          # past tiny mixtral's window of 64
NO_DROP_CF = 8.0
# bf16 rounds the hidden state a router sees to 2^-8 of its size, in other
# places in the two packages; that moves a router logit by ~1e-3 of its
# size, and a probability by as much of itself. So rounding alone can swap
# the k-th and (k+1)-th experts only where their probabilities lie within a
# few times that of each other: 1e-2 of the k-th (measured on tiny
# mixtral-8x22b: flips at 4.3e-4, 7.0e-4 and 4.6e-3).
FLIP_MARGIN = 1e-2
# name: (arch, overrides of reduced(); "moe" as (experts, top k))
CASES = {
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "mixtral": ("mixtral-8x22b", {}),
    "dbrx": ("dbrx-132b", {}),
    "moonshot-e64": ("moonshot-v1-16b-a3b", {"d_ff": 128, "moe": (64, 6)}),
    "dense+moe": ("qwen2.5-3b", {"moe": (4, 2)}),
}
CFS = [NO_DROP_CF, None]       # None: the config's own capacity factor


def _configs(case: str, dtype: str, cf: float | None):
    """(reference config, port config) of a case: the same fields."""
    arch, over = CASES[case]
    over = dict(over, dtype=dtype)
    out = []
    for get, red, moe_cls in ((jget_config, jreduced, JMoEConfig),
                              (get_config, reduced, MoEConfig)):
        kw = dict(over)
        if "moe" in kw:
            kw["moe"] = moe_cls(*kw["moe"])
        cfg = red(get(arch), **kw)
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


@pytest.fixture(scope="module")
def pairs(jax_rules):
    """pairs(case, dtype, cf) -> (JAX model, JAX params, port model, port
    fp32 masters): the same weights, made once per case, dtype and
    capacity factor in this module."""
    made = {}

    def pair(case, dtype="float32", cf=None):
        if (case, dtype, cf) not in made:
            jcfg, cfg = _configs(case, dtype, cf)
            jm = JModel(jcfg, jax_rules)
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu", dtype=torch.float32)
            made[case, dtype, cf] = jm, jp, Model(cfg, device="cpu"), tp
        return made[case, dtype, cf]

    return pair


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _rel(j, t):
    j = np.asarray(j, np.float32)
    return float(np.linalg.norm(t.detach().float().numpy() - j)
                 / max(np.linalg.norm(j), 1e-30))


class Routes:
    """Records (probs, expert ids) of every ``router_topk`` call, of the
    port's or, with ``reference=True``, of the reference's (through a
    debug callback, so it must be in place before the reference's call is
    traced)."""

    def __init__(self, monkeypatch, *, reference: bool = False):
        self.calls = []
        mod = jmoe if reference else moe
        inner = mod.router_topk

        def keep(probs, idx):
            self.calls.append((np.array(probs, np.float32), np.array(idx)))

        def recorded(x32, router_w, k):
            out = inner(x32, router_w, k)
            if reference:
                jax.debug.callback(keep, out[0], out[2])
            else:
                keep(out[0].detach().numpy(), out[2].numpy())
            return out

        monkeypatch.setattr(mod, "router_topk", recorded)

    def dropped(self, m) -> int:
        """Assignments dropped over the recorded calls, at ``m``'s
        capacity."""
        e = m.cfg.moe.num_experts
        n = 0
        for _, idx in self.calls:
            cap = moe.capacity_for(idx.shape[0], m.cfg.moe)
            keep = moe._dispatch_indices(torch.from_numpy(idx), idx.shape[0],
                                         e, cap)[4]
            n += int((~keep).sum())
        return n


def flipped_tokens(ref_calls, port_calls, k: int) -> np.ndarray:
    """The tokens of one step (its layers' router calls, in order) whose
    expert set differs between the packages, [T] bool. A token's first
    flip must come at a near-tie: its k-th and (k+1)-th reference
    probabilities within FLIP_MARGIN of the k-th. A token that already
    flipped may flip again at any margin (its state moved by O(1))."""
    flipped = None
    for (jp, ji), (_, ti) in zip(ref_calls, port_calls, strict=True):
        diff = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
        flipped = np.zeros_like(diff) if flipped is None else flipped
        top = -np.sort(-jp, -1)
        margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        first = diff & ~flipped
        assert (margin[first] <= FLIP_MARGIN).all(), margin[first]
        flipped |= diff
    return flipped


# -------------------------------------------------------------- units ---

def _router_inputs(t=37, d=24, e=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            (0.3 * rng.standard_normal((d, e))).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2, 6])
def test_router_topk_matches_reference(k):
    """The router runs in fp32 on bf16 weights' values, as serving's."""
    x, w = _router_inputs()
    probs, gate, idx = moe.router_topk(torch.from_numpy(x),
                                       torch.from_numpy(w).bfloat16(), k)
    jp, jg, ji = jmoe.router_topk(
        jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16), k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gate.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert probs.dtype == gate.dtype == torch.float32
    torch.testing.assert_close(gate.sum(-1), torch.ones(gate.shape[0]))


def test_router_topk_ties_go_to_the_lower_expert():
    """Experts 1, 3 and 6 have the same router column, so every token
    gives them the same probability, the largest: the top 2 are 1 then 3
    in both packages, and the top 3 add 6."""
    x, w = _router_inputs(t=16, d=8, e=8, seed=1)
    x = np.abs(x)
    w = -np.abs(w)
    w[:, [1, 3, 6]] = 1.0
    for k in (2, 3):
        _, _, ji = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k)
        _, _, idx = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
        want = np.array([1, 3, 6][:k])
        np.testing.assert_array_equal(np.asarray(ji), np.tile(want, (16, 1)))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    # a tie below the top: experts 0 and 5 tie for second place
    w = -np.abs(_router_inputs(t=16, d=8, e=8, seed=2)[1]) - 1.0
    w[:, 2] = 1.0
    w[:, [0, 5]] = 0.5
    _, _, ji = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), 3)
    _, _, idx = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert (idx.numpy() == [2, 0, 5]).all()


def test_load_balance_aux_matches_reference_and_its_gradient():
    """E sum f p over the first choice: f carries no gradient, p does."""
    x, w = _router_inputs(t=50, e=8, seed=3)
    for k in (1, 2):
        def jaux(w):
            p, _, i = jmoe.router_topk(jnp.asarray(x), w, k)
            return jmoe.load_balance_aux(p, i, 8)
        jv, jg = jax.value_and_grad(jaux)(jnp.asarray(w))
        tw = torch.from_numpy(w).requires_grad_()
        p, _, i = moe.router_topk(torch.from_numpy(x), tw, k)
        aux = moe.load_balance_aux(p, i, 8)
        aux.backward()
        np.testing.assert_allclose(aux.item(), float(jv), rtol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("tokens,e,k,cf", [
    (8, 64, 6, 1.25), (8192, 64, 6, 1.25), (4096, 64, 6, 1.25),
    (1, 4, 2, 1.25), (7, 8, 2, 1.25), (100, 16, 4, 1.25), (3, 4, 2, 8.0),
    (2046, 64, 6, 64 / 6), (13, 3, 1, 0.5)])
def test_capacity_for_matches_reference(tokens, e, k, cf):
    got = moe.capacity_for(tokens, MoEConfig(e, k, capacity_factor=cf))
    assert got == jmoe.capacity_for(tokens, JMoEConfig(e, k,
                                                       capacity_factor=cf))


def test_capacity_at_moonshots_serving_shapes():
    """A decode step of 8 tokens keeps one assignment an expert; a
    prefill of 8 x 1024 keeps 960; the consistency check's E/k keeps
    every token."""
    m = get_config("moonshot-v1-16b-a3b").moe
    assert moe.capacity_for(8, m) == 1
    assert moe.capacity_for(8 * 1024, m) == 960
    wide = dataclasses.replace(m, capacity_factor=m.num_experts
                               / m.experts_per_token)
    for t in (2, 2 * 1023, 2 * 1024, 8):
        assert moe.capacity_for(t, wide) >= t


@pytest.mark.parametrize("t,e,k,cap,seed", [
    (40, 4, 2, 12, 0),       # drops
    (40, 4, 2, 80, 1),       # none
    (9, 64, 6, 1, 2),        # a decode step's capacity of 1
    (33, 8, 3, 5, 3)])
def test_dispatch_indices_match_reference(t, e, k, cap, seed):
    idx = np.random.default_rng(seed).integers(0, e, (t, k))
    # distinct experts per token, as top-k gives
    idx = np.stack([np.random.default_rng(seed + i).permutation(e)[:k]
                    for i in range(t)])
    ref = jmoe._dispatch_indices(jnp.asarray(idx, jnp.int32), t, e, cap)
    got = moe._dispatch_indices(torch.from_numpy(idx), t, e, cap)
    for name, j, g in zip(("order", "se", "st", "pos", "keep"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    if cap == 12:
        assert not got[4].all()


def test_dispatch_keeps_the_earlier_tokens_of_a_full_expert():
    """Every token's first choice is expert 2: the stable sort keeps them
    in token order, so the first ``cap`` tokens are kept, the rest
    dropped, in both packages."""
    t, e, k, cap = 20, 4, 2, 7
    idx = np.stack([np.full(t, 2), np.arange(t) % 2 * 3], 1)
    ref = jmoe._dispatch_indices(jnp.asarray(idx, jnp.int32), t, e, cap)
    got = moe._dispatch_indices(torch.from_numpy(idx), t, e, cap)
    for j, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    order, se, st, pos, keep = (g.numpy() for g in got)
    kept = st[(se == 2) & keep]
    assert list(kept) == list(range(cap))


def _block_inputs(b, s, d, e, f, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, s, d))).astype(np.float32),
            (0.1 * rng.standard_normal((d, e))).astype(np.float32),
            (0.1 * rng.standard_normal((e, d, f))).astype(np.float32),
            (0.1 * rng.standard_normal((e, d, f))).astype(np.float32),
            (0.1 * rng.standard_normal((e, f, d))).astype(np.float32))


@pytest.mark.parametrize("e,k,cf,dtype", [
    (4, 2, 1.25, "float32"), (4, 2, 8.0, "float32"), (64, 6, 1.25, "float32"),
    (8, 2, 1.25, "bfloat16"), (16, 4, 0.6, "float32")])
def test_block_matches_make_sharded_moe(jax_rules, e, k, cf, dtype):
    """y, aux and the gradients of x and of every weight, against the
    reference's block on the (1, 1) mesh, drops included."""
    b, s, d, f = 2, 24, 32, 16
    cfg = (JMoEConfig(e, k, capacity_factor=cf),
           MoEConfig(e, k, capacity_factor=cf))
    arrs = _block_inputs(b, s, d, e, f, seed=e + k)
    jdt = getattr(jnp, dtype)
    block = jmoe.make_sharded_moe(jax_rules.mesh, moe=cfg[0])

    def jloss(x, rw, wg, wu, wd, dy):
        y, aux = block(x.astype(jdt), rw, wg, wu, wd)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux, (y, aux)

    dy = np.random.default_rng(9).standard_normal((b, s, d)).astype(np.float32)
    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*arrs, dy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tdt = getattr(torch, dtype)
    y, aux = moe.moe_block(leaves[0].to(tdt), *leaves[1:], moe=cfg[1])
    assert y.dtype == tdt and y.shape == (b, s, d) and aux.dtype == torch.float32
    ((y.float() * torch.from_numpy(dy)).sum() + aux).backward()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    if dtype == "float32":
        _close_leaf("y", jy, y, tol)
        for name, j, t in zip(("x", "router", "w_gate", "w_up", "w_down"), jg,
                              leaves):
            _close_leaf(name, j, t.grad, tol)
    else:
        assert _rel(jy, y) <= tol
        for j, t in zip(jg, leaves):
            assert _rel(j, t.grad) <= tol
    cap = moe.capacity_for(b * s, cfg[1])
    _, _, idx = moe.router_topk(torch.from_numpy(arrs[0]).reshape(-1, d)
                                .to(tdt).float(), torch.from_numpy(arrs[1]), k)
    kept = moe._dispatch_indices(idx, b * s, e, cap)[4]
    print(f"E={e} k={k} cf={cf}: capacity {cap}, "
          f"{int((~kept).sum())} of {b * s * k} assignments dropped")
    if cf < 1:
        assert not kept.all()         # the drop path ran
    if cf >= e / k:
        assert kept.all()


def test_block_is_bit_equal_from_call_to_call():
    """Two calls, forward and backward, on the same inputs: the same bits
    (every index the block moves rows by is unique, and the combine adds a
    token's rows in a fixed order)."""
    arrs = _block_inputs(2, 40, 32, 8, 16, seed=4)
    cfg = MoEConfig(8, 2)
    outs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
                      for a in arrs]
            y, aux = moe.moe_block(*leaves, moe=cfg)
            (y.float().square().sum() + aux).backward()
            outs.append([y, aux] + [t.grad for t in leaves])
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------------------------ serving ---

def _rows_rel(j, t, keep) -> float:
    """Relative L2 error over the rows ``keep`` (a mask of the leading
    dims) of both."""
    j = np.asarray(j, np.float32)[keep]
    t = t.float().numpy()[keep]
    return float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30))


def _prefill_and_decode(jm, jp, m, tp, toks, monkeypatch, check):
    """The reference's and the port's prefill, then three decode steps of
    the reference's greedy tokens. After each, ``check(name, position of
    the logits, jax logits, port logits, jax caches, port caches, bad)``:
    ``bad`` [B, positions]
    marks the tokens whose experts differed between the packages so far
    (``flipped_tokens``). Returns the port's router calls."""
    jr, tr = (Routes(monkeypatch, reference=True), Routes(monkeypatch))
    b, s = toks.shape
    n_layers, k = m.cfg.num_layers, m.cfg.moe.experts_per_token
    bad = np.zeros((b, s + 3), bool)

    def step(name, pos, run_ref, run_port, rows):
        start = len(tr.calls)
        jl, jc = jax.block_until_ready(run_ref())
        tl, tc = run_port()
        assert len(jr.calls) == len(tr.calls) == start + n_layers
        flips = flipped_tokens(jr.calls[start:], tr.calls[start:], k)
        bad[rows] |= flips.reshape(b, -1)
        check(name, pos, jl, tl, jc, tc, bad)
        return jl, jc, tc

    jl, jc, tc = step("prefill", s - 1, lambda: jax.jit(
        lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=CACHE_LEN))(
            jp, jnp.asarray(toks)),
        lambda: m.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          cache_len=CACHE_LEN), np.s_[:, :s])
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        pos = s + i
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc, tc = step(
            f"decode {i}", pos,
            lambda: decode(jp, jnp.asarray(nxt), jc, jnp.int32(pos)),
            lambda: m.decode_step(tp, torch.from_numpy(nxt), tc, pos),
            np.s_[:, pos:pos + 1])
    return tr


def _assert_caches(jc, tc, tol, bad=None):
    """Every cache leaf: fp32 elementwise, or (``bad`` given) bf16 by the
    relative L2 error over the ring slots of tokens that routed alike."""
    assert set(jc) == set(tc) == set(KV_CACHE)
    sp = tc["slot_pos"].numpy()
    np.testing.assert_array_equal(np.asarray(jc["slot_pos"]), sp)
    for name in ("k", "v"):
        j, t = jc[name], tc[name]
        assert tuple(t.shape) == j.shape, name
        if bad is None:
            _close_leaf(name, j, t, tol)
            continue
        # [L, B, W]: slot w of layer l holds position sp[l, w] (or none)
        alike = (sp[:, None, :] >= 0) & ~np.take_along_axis(
            bad[None], np.maximum(sp, 0)[:, None, :].repeat(
                bad.shape[0], 1), axis=2)
        assert alike.any()
        assert _rows_rel(j, t, alike) <= tol, name


@pytest.mark.parametrize("cf", CFS, ids=["cf8", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_then_decode_matches_reference(pairs, monkeypatch, case,
                                               cf):
    """fp32: every token routes as in the reference, nothing drops at
    capacity factor 8 and something does at the default."""
    jm, jp, m, tp = pairs(case, cf=cf)
    assert m.cache_window(CACHE_LEN) == jm.cache_window(CACHE_LEN)
    assert m.cache_shapes(2, CACHE_LEN)["k"][0] == m.cfg.num_layers
    toks = _tokens(m.cfg.vocab_size, 2, S, seed=len(case))

    def check(where, pos, jl, tl, jc, tc, bad):
        assert not bad.any(), where
        assert tl.dtype == torch.float32 and tl.shape == (2, m.cfg.vocab_size)
        _close_leaf(f"logits, {where}", jl, tl, FP32_TOL)
        _assert_caches(jc, tc, FP32_TOL)

    routes = _prefill_and_decode(jm, jp, m, tp, toks, monkeypatch, check)
    dropped = routes.dropped(m)
    if cf == NO_DROP_CF:
        assert dropped == 0
    else:
        assert dropped > 0            # the drop path ran
    if case == "moonshot-e64":
        # a decode step of 2 tokens keeps one assignment an expert
        assert moe.capacity_for(2, m.cfg.moe) == (1 if cf is None else 2)


@pytest.mark.parametrize("cf", CFS, ids=["cf8", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_prefill_and_decode_match_reference(pairs, monkeypatch, case,
                                                 cf):
    """bf16: a token may take another expert only at a near-tie
    (``flipped_tokens``), which moves its row by O(1), not by rounding; so
    the logits and cache rows are held to the bf16 tolerance over the
    tokens that routed alike, and a sequence's logits once its step's
    token flipped are not compared."""
    jm, jp, m, tp = pairs(case, "bfloat16", cf)
    tp = m.serving_params(tp)
    assert tp["layers"]["router"].dtype == torch.bfloat16
    toks = _tokens(m.cfg.vocab_size, 2, S, seed=5)
    compared = []

    def check(where, pos, jl, tl, jc, tc, bad):
        rows = ~bad[:, pos]
        if rows.any():
            assert _rows_rel(jl, tl, rows) <= BF16_TOL, where
        compared.append(int(rows.sum()))
        _assert_caches(jc, tc, BF16_TOL, bad)

    _prefill_and_decode(jm, jp, m, tp, toks, monkeypatch, check)
    assert sum(compared) >= 6         # of 8 rows of logits


def test_prefill_agrees_with_prefill_plus_decode(pairs):
    """With capacity for every token nothing drops, and prefill(S)'s last
    logits equal prefill(S-1) then decode_step(token S-1)."""
    _, _, m, tp = pairs("moonshot-e64", cf=64 / 6)
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, 2, 70, seed=3))
    full, _ = m.prefill(tp, {"tokens": toks}, cache_len=CACHE_LEN)
    _, cache = m.prefill(tp, {"tokens": toks[:, :-1]}, cache_len=CACHE_LEN)
    step, _ = m.decode_step(tp, toks[:, -1:], cache, 69)
    torch.testing.assert_close(step, full, atol=FP32_TOL, rtol=FP32_TOL)
