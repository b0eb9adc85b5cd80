"""The port's SSM (Mamba2) training path against the JAX package's: the SSD
scan's gradients, the SSD backward kernel's algorithm, and tiny
mamba2-370m's ``train_loss``, gradients, train step, training loop and
launcher; with the reference's own weights carried across as numpy. The
CUDA backward kernel itself is held against its plain version on a card
(tests/test_torch_kernels.py, chip_smoke.py).

The reference runs on an Auto-axis (1, 1) mesh, always under ``jax.jit``,
as in tests/test_torch_train.py; its SSD gradients are ``jax.grad`` of the
pure-jnp ``ssd_chunked`` (no TPU kernel had a backward). Inputs are made
from a seed with numpy.

Tolerances: the SSD gradients in fp32 to 2e-4 of each output's largest
entry (sums over a few hundred fp32 terms in another order; measured
~1e-6); the model's loss and gradients in fp32 to 2e-4 (two layers of fp32
arithmetic summed in another order; each gradient leaf's absolute
tolerance scaled by its largest entry); bf16 to 4e-2 by each leaf's
relative L2 error (bf16 rounds at different places in the two frameworks);
the kernel's algorithm with its bf16 outputs against the card's gate,
2e-2 by the worst row with a floor of 1e-2 of the median row (chip_smoke.py's
GRAD_ROW_RTOL, GRAD_ROW_FLOOR).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.synthetic import SyntheticStream as JStream
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.sharding.rules import make_rules
from repro.train.loop import train_loop as jtrain_loop
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (row_rel_err, ssd_backward_reference,
                                     ssd_backward_tiles)
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.loop import train_loop
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_ssm import GRID, _inputs
from test_torch_train import _close_leaf, _leaves

FP32_TOL = 2e-4
BF16_TOL = 4e-2
GRAD_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2
ARCH = "mamba2-370m"
B, S = 2, 40          # two of the tiny config's chunks of 32, the second padded
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def _pair(jax_rules, dtype: str, **port_kw):
    """(JAX model, JAX params, port model, port fp32 masters): the same
    weights."""
    jm = JModel(jreduced(jget_config(ARCH), dtype=dtype), jax_rules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype=dtype)
    m = Model(cfg, device="cpu", **port_kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jm, jp, m, tp


@pytest.fixture(scope="module")
def fp32_pair(jax_rules):
    return _pair(jax_rules, "float32")


def _batch(vocab: int, step: int = 0):
    raw = JStream(vocab, 0).batch(step, B, S)
    return ({"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])},
            {"tokens": torch.from_numpy(raw[:, :-1].copy()),
             "labels": torch.from_numpy(raw[:, 1:].copy())})


def _port_grads(m, tp, batch):
    grads = adamw.tree_map(torch.zeros_like, tp)
    loss, metrics = loss_and_grads(m, tp, batch, grads)
    return loss, metrics, grads


# ------------------------------------------------------- the SSD scan ---

def _jax_ssd_grads(arrays, dy, chunk):
    """jax.grad of sum(ssd_chunked(...) * dy) over x, dt, A, B, C, D."""
    def loss(*args):
        return jnp.sum(jssm.ssd_chunked(*args, chunk=chunk) * dy)
    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in arrays))


def _case(b, s, h, p, g, n, seed, dist="jax"):
    """test_torch_ssm.py's inputs and dy ~ N(0, 1); with ``dist="model"``
    dt and A as the model initialises them (dt log-uniform in [1e-3, 1e-1],
    A = -U[1, 16]), whose tiles decay from ~1 to ~e^-50, where the JAX
    tests' dt decays a tile of 32 by ~e^-30."""
    arrays = _inputs(b, s, h, p, g, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if dist == "model":
        x, _, _, B, C, D = arrays
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
        A = -rng.uniform(1.0, 16.0, h)
        arrays = (x, dt.astype(np.float32), A.astype(np.float32), B, C, D)
    return arrays, dy


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_ssd_op_grads_match_jax(b, s, h, p, g, n, chunk):
    """ssd_op's CPU path differentiated by autograd against jax.grad of the
    JAX model's ssd_chunked, every input's gradient."""
    arrays, dy = _case(b, s, h, p, g, n, seed=s + h)
    jg = _jax_ssd_grads(arrays, dy, chunk)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _ = ops.ssd_op(*leaves, chunk=chunk)
    (y * torch.from_numpy(dy)).sum().backward()
    for name, j, t in zip(GRAD_NAMES, jg, leaves):
        _close_leaf(name, j, t.grad, FP32_TOL)


@pytest.mark.parametrize("dist", ["jax", "model"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", GRID)
def test_tile_walk_matches_jax(b, s, h, p, g, n, chunk, dist):
    """The backward kernel's algorithm (tiles of 32, the two walks over the
    tiles, the per-head dB / dC summed over each group) against jax.grad,
    and the kernel's plain version too."""
    arrays, dy = _case(b, s, h, p, g, n, seed=s + h, dist=dist)
    jg = _jax_ssd_grads(arrays, dy, chunk)
    targs = [torch.from_numpy(a) for a in arrays]
    tiles = ssd_backward_tiles(*targs, torch.from_numpy(dy))
    plain = ssd_backward_reference(*targs, torch.from_numpy(dy), chunk=chunk)
    for name, j, t, r in zip(GRAD_NAMES, jg, tiles, plain):
        assert t.shape == r.shape == np.shape(j) and t.dtype == torch.float32
        _close_leaf(name, j, t, FP32_TOL)
        _close_leaf(f"{name} (plain)", j, r, FP32_TOL)


@pytest.mark.parametrize("dist", ["jax", "model"])
def test_tile_walk_passes_the_card_gate(dist):
    """At mamba2-370m's head and state sizes over eight tiles, from bf16
    inputs, with dx / dB / dC rounded to bf16 as the kernel writes them:
    every gradient within the card's gate of the plain version, with room."""
    arrays, dy = _case(2, 256, 4, 64, 1, 128, seed=21, dist=dist)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrays)
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    dy = torch.from_numpy(dy).bfloat16()
    got = list(ssd_backward_tiles(x, dt, A, Bm, Cm, D, dy))
    for i in (0, 3, 4):
        got[i] = got[i].bfloat16()
    ref = ssd_backward_reference(x, dt, A, Bm, Cm, D, dy, chunk=256)
    for name, t, r in zip(GRAD_NAMES, got, ref):
        err = row_rel_err(t, r, floor=GRAD_ROW_FLOOR)
        assert err <= GRAD_ROW_RTOL / 2, (name, err)


def test_tile_walk_without_the_state_walk_fails_the_gate():
    """The gate sees a lost cross-tile term: the same walk with every
    tile's state gradient zeroed (dS_out = 0, as if the reverse walk were
    skipped) moves dx, dB and ddt past it."""
    arrays, dy = _case(1, 128, 2, 32, 1, 16, seed=22, dist="model")
    targs = [torch.from_numpy(a) for a in arrays]
    dy = torch.from_numpy(dy)
    ref = ssd_backward_reference(*targs, dy, chunk=32)
    # four tiles of 32 computed as four separate sequences: no state crosses
    parts = [ssd_backward_tiles(*(t[:, k:k + 32] if t.dim() > 1 else t
                                  for t in targs), dy[:, k:k + 32])
             for k in range(0, 128, 32)]
    cut = [torch.cat([part[i] for part in parts], dim=1) for i in (0, 1, 3)]
    errs = [row_rel_err(t, ref[i], floor=GRAD_ROW_FLOOR)
            for t, i in zip(cut, (0, 1, 3))]
    assert all(e > GRAD_ROW_RTOL for e in errs), errs


# --------------------------------------------------------- the model ---

def test_train_loss_and_grads_match_reference_fp32(fp32_pair):
    jm, jp, m, tp = fp32_pair
    jb, tb = _batch(m.cfg.vocab_size)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    loss, met, grads = _port_grads(m, tp, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=FP32_TOL)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=FP32_TOL)
    assert met["aux"].item() == float(jmet["aux"]) == 0.0
    for name, j, t in _leaves(jgrads, grads):
        _close_leaf(name, j, t, FP32_TOL)


def test_train_loss_and_grads_match_reference_bf16(jax_rules):
    """bf16 compute over fp32 masters on both sides: the loss to 4e-2 and
    each gradient leaf by its relative L2 error to 4e-2."""
    jm, jp, m, tp = _pair(jax_rules, "bfloat16")
    jb, tb = _batch(m.cfg.vocab_size, step=1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    loss, _, grads = _port_grads(m, tp, tb)
    assert tp["layers"]["x_proj"].dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)
    for name, j, t in _leaves(jgrads, grads):
        j = np.asarray(j, np.float32)
        err = np.linalg.norm(t.numpy() - j) / max(np.linalg.norm(j), 1e-30)
        assert err <= BF16_TOL, (name, err)


def test_remat_gives_the_same_gradients(fp32_pair):
    _, _, m, tp = fp32_pair
    _, tb = _batch(m.cfg.vocab_size, step=2)
    assert m.remat
    loss, _, grads = _port_grads(m, tp, tb)
    plain = Model(m.cfg, device="cpu", remat=False)
    loss2, _, grads2 = _port_grads(plain, tp, tb)
    assert loss.item() == loss2.item()
    for t, t2 in zip(adamw.tree_leaves(grads), adamw.tree_leaves(grads2)):
        assert torch.equal(t, t2)


def test_grads_land_in_the_stacked_buffers(fp32_pair):
    """Each layer's gradient is added in place into the stacked buffer:
    the same as autograd through the stacked leaves, the SSM's fp32
    leaves (A_log, D, dt_bias, the convolutions) among them."""
    _, _, m, tp = fp32_pair
    _, tb = _batch(m.cfg.vocab_size, step=3)
    _, _, grads = _port_grads(m, tp, tb)
    leaves = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
    m.train_loss(leaves, tb)[0].backward()
    for name, t in leaves["layers"].items():
        torch.testing.assert_close(grads["layers"][name], t.grad, rtol=1e-6,
                                   atol=1e-7)
        assert torch.count_nonzero(t.grad) > 0, name
    torch.testing.assert_close(grads["embed"], leaves["embed"].grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_masters_serve_like_cast_parameters(jax_rules, dtype):
    """Every projection is cast to the activations' dtype where it is used:
    prefill and decode_step over fp32 masters are bit-equal to the same
    calls over ``serving_params`` of them (each master rounded once)."""
    _, _, m, tp = _pair(jax_rules, dtype)
    cast = m.serving_params(tp)
    toks = torch.from_numpy(JStream(m.cfg.vocab_size, 0).batch(0, 2, 13))
    with torch.no_grad():
        a, ca = m.prefill(tp, {"tokens": toks[:, :12]}, cache_len=16)
        b, cb = m.prefill(cast, {"tokens": toks[:, :12]}, cache_len=16)
        assert torch.equal(a, b)
        a, ca = m.decode_step(tp, toks[:, 12:], ca, 12)
        b, cb = m.decode_step(cast, toks[:, 12:], cb, 12)
    assert torch.equal(a, b)
    for name in ca:
        assert torch.equal(ca[name], cb[name]), name


def test_mamba_sublayer_refuses_an_unknown_mode(fp32_pair):
    _, _, m, tp = fp32_pair
    p = m._layer_params(tp)[0]
    with pytest.raises(ValueError, match="mode"):
        m.mamba_sublayer(p, torch.zeros((1, 4, m.cfg.d_model)), None,
                         mode="serve")


# ------------------------------------------------------------ the step ---

def test_train_step_matches_reference(fp32_pair):
    """Three steps of make_train_step: the metrics, params, mu, nu and
    step. The parameters are also allowed 1% of the largest move Adam can
    make over the steps (the sum of their learning rates), as in
    tests/test_torch_train.py: Adam normalises each element, so an element
    whose gradient is near the fp32 noise of the loss takes an update off
    by that much, while mu and nu stay within 2e-4."""
    jm, jp, m, tp = fp32_pair
    tp = adamw.tree_map(torch.clone, tp)
    jstep = jax.jit(jmake_train_step(jm, jadamw.AdamWConfig()))
    tstep = make_train_step(m, adamw.AdamWConfig())
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    moved = 0.0
    for step in range(3):
        jb, tb = _batch(m.cfg.vocab_size, step)
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert set(tmet) == set(jmet)
        for key in tmet:
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=FP32_TOL, atol=1e-7, err_msg=key)
        moved += float(tmet["lr"])
    for part, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        for name, j, t in _leaves(jt, tt):
            _close_leaf(f"{part}/{name}", j, t, FP32_TOL,
                        atol=1e-2 * moved if part == "params" else 0.0)
    assert ts["step"].item() == int(js["step"]) == 3


def test_train_loop_history_matches_reference(jax_rules):
    jm, jp, m, tp = _pair(jax_rules, "float32")
    _, _, jhist = jtrain_loop(jm, batch=B, seq_len=S, steps=5, log_every=2,
                              log_fn=lambda _: None,
                              params=jax.tree.map(jnp.copy, jp))
    _, _, hist = train_loop(m, batch=B, seq_len=S, steps=5, log_every=2,
                            log_fn=lambda _: None, params=tp)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 2, 4]
    for h, jh in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=FP32_TOL)
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"],
                                   rtol=FP32_TOL)


def test_train_cli_loss_falls_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                    "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and "mamba2-370m-tiny" in done[0]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert last < first
