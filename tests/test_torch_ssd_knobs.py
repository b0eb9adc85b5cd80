"""The reference's SSD numerics knobs, ``Rules.ssd_compute_dtype`` and
``Rules.ssm_chunk``, on the port's plain path against the JAX package's
``Model``, and the card's bf16-intra instances of both SSD kernels
emulated on the CPU.

Tiny mamba2-370m here and tiny zamba2-1.2b in
tests/test_torch_ssd_knobs_hybrid.py, in fp32 and in bf16, at every
combination of ``ssd_compute_dtype`` in {float32, bfloat16} and
``ssm_chunk`` in {0, 16, 64} (0: the config's 32); S = 100, so that every
chunk pads. Each pair is compared on prefill logits, three greedy decode
steps, ``train_loss`` and every gradient leaf. The reference runs on an
Auto-axis (1, 1) mesh, ``make_rules(mesh, **knobs)``, its loss and
gradients under ``jax.jit``; the port on ``single_device_rules(**knobs)``;
the same weights, carried across as numpy.

Tolerances:
  * fp32 model: the logits, the decodes' and the loss to 2e-4 at either
    compute dtype (fp32 arithmetic summed in another order; measured
    ~1e-6 at both: the knob's casts are the same in both packages); the
    gradient leaves to 2e-4 at fp32 compute (measured ~4e-6) and, at bf16
    compute, by each leaf's relative L2 error to ``BF16_COMPUTE_GRAD_TOL``
    = 1e-2 (measured up to 3.5e-3, the conv weights of B and C: torch and
    XLA round the bf16 einsums' transposes at other places; the scan alone
    differs by 9.6e-3 between the packages at chunk 256).
  * bf16 model: each output by its relative L2 error to ``BF16_TOL`` =
    4e-2, as in tests/test_torch_mamba.py and tests/test_torch_train_ssm.py
    (measured up to 1.04e-2 in the logits, 2.9e-2 in a gradient leaf, at
    either compute dtype).
  * bf16 compute moves each package's fp32 model's logits from its fp32
    compute by more than the fp32 tolerance, the packages staying within
    it of each other: the knob reaches the scan on both sides
    (``test_bf16_compute_moves_both_packages``).

The emulated kernels (``_emulate_ssd_kernel(m_parts=1)``, the forward's
bf16-intra instance; ``ssd_backward_tiles(split=True, hi_only=("m",
"q"))``, the backward's) are held to the reference's fp32 y and gradients
within ``KNOB_BUDGET`` = 1.5 times the reference's own bf16-vs-fp32 error
at the same inputs, or the default instance's gate where the knob leaves
an output as it was (the final state, dD): chip_smoke.py's [ssd knobs]
gate, worst row with a floor of 1e-2 of the median row. Measured at B = 2,
S = 1024, H = 4, P = 64, N = 128 under the JAX tests' draws: y 3.4e-2
against the reference's 7.6e-2; dx 1.07e-1 against 8.2e-2 (1.3x: the
forward's one rounding of M halves the reference's error, the backward's
of M and Q does not), dB 5.6e-2 against 1.95e-1, dC 2.4e-2 against
3.3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.ref import row_rel_err, ssd_backward_tiles
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.sharding.rules import single_device_rules
from repro_torch.train.step import loss_and_grads
from test_torch_ssm import _emulate_ssd_kernel, _inputs
from test_torch_train import _close_leaf, _leaves

FP32_TOL = 2e-4
BF16_COMPUTE_GRAD_TOL = 1e-2
BF16_TOL = 4e-2
B, S, DECODES = 2, 100, 3
ARCH = "mamba2-370m"
KNOBS = [(cd, k) for cd in ("float32", "bfloat16") for k in (0, 16, 64)]
# chip_smoke.py's [ssd knobs] budget and the default instances' gates
KNOB_BUDGET = 1.5
SSD_Y_ROW_RTOL = 1e-2
SSD_STATE_ROW_RTOL = 1e-3
GRAD_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def draw_weights(arch: str, mesh) -> dict:
    """{(arch, dtype): (the reference's params, the port's config)}: one
    draw per config, whatever the knobs."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = JModel(jreduced(jget_config(arch), dtype=dtype),
                    make_rules(mesh))
        out[arch, dtype] = (jm.init(jax.random.key(0)),
                            reduced(get_config(arch), dtype=dtype))
    return out


@pytest.fixture(scope="module")
def weights(jax_mesh):
    return draw_weights(ARCH, jax_mesh)


def _models(jax_mesh, weights, arch, dtype, cd, chunk):
    """(JAX model, JAX params, port model, port serving params, port fp32
    masters) under the knobs."""
    knobs = dict(ssd_compute_dtype=cd, ssm_chunk=chunk)
    jp, cfg = weights[arch, dtype]
    jm = JModel(jreduced(jget_config(arch), dtype=dtype),
                make_rules(jax_mesh, **knobs))
    m = Model(cfg, single_device_rules(**knobs), device="cpu")
    np_params = jax.tree.map(np.asarray, jp)
    return (jm, jp, m, params_from_numpy(np_params, cfg, device="cpu"),
            params_from_numpy(np_params, cfg, device="cpu",
                              dtype=torch.float32))


def _rel(j, t) -> float:
    j = np.asarray(j, np.float32)
    return float(np.linalg.norm(t.detach().float().numpy() - j)
                 / max(np.linalg.norm(j), 1e-30))


def _serve(jm, jp, m, tp, decodes: int = DECODES):
    """Prefill logits and ``decodes`` greedy steps (the reference's tokens
    fed to both; its prefill and decode step jitted): [(reference logits,
    port logits)]."""
    toks = np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(toks)}, cache_len=128)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=128)
    out = [(jl, tl)]
    step = jax.jit(jm.decode_step)
    for pos in range(S, S + decodes):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = step(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        out.append((jl, tl))
    return out


def _batch(vocab: int):
    raw = np.random.default_rng(2).integers(0, vocab, (B, S + 1)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(raw[:, :-1]),
             "labels": jnp.asarray(raw[:, 1:])},
            {"tokens": torch.from_numpy(raw[:, :-1].copy()),
             "labels": torch.from_numpy(raw[:, 1:].copy())})


def check_knobs(jax_mesh, weights, arch, dtype, cd, chunk) -> None:
    """One (arch, dtype, knobs) case: prefill logits, the decodes, the
    loss and every gradient leaf, port against reference, at the module
    docstring's tolerances."""
    jm, jp, m, tp, masters = _models(jax_mesh, weights, arch, dtype, cd,
                                     chunk)
    fp32 = dtype == "float32"
    for i, (jl, tl) in enumerate(_serve(jm, jp, m, tp)):
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        if fp32:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=FP32_TOL, rtol=FP32_TOL,
                                       err_msg=f"step {i}")
        else:
            assert _rel(jl, tl) <= BF16_TOL, (i, _rel(jl, tl))

    jb, tb = _batch(m.cfg.vocab_size)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    grads = adamw.tree_map(torch.zeros_like, masters)
    loss, _ = loss_and_grads(m, masters, tb, grads)
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=FP32_TOL if fp32 else BF16_TOL)
    tol = BF16_COMPUTE_GRAD_TOL if fp32 else BF16_TOL
    for name, j, t in _leaves(jgrads, grads):
        if fp32 and cd == "float32":
            _close_leaf(name, j, t, FP32_TOL)
        else:
            assert _rel(j, t) <= tol, (name, _rel(j, t))


def check_knob_moves(jax_mesh, weights, arch) -> None:
    """The fp32 model's prefill logits at bf16 compute differ from its fp32
    compute's by more than the fp32 tolerance in each package, and the
    packages still agree to it at both: neither drops the knob, and both
    round at the same casts. With the init's weights the scan's intra
    term is a sliver of the logits (the knob moves them by ~5e-6, the
    skip term D x and dt ~ 1e-2 carry the block): here D = 0 and dt_bias
    = 1 (dt ~ 1.3, the JAX kernel tests' scale), in both packages, and it
    moves them by ~2.5e-3 (the packages 4e-7 apart)."""
    jp, cfg = weights[arch, "float32"]
    layers = dict(jp["layers"], ssm_D=jnp.zeros_like(jp["layers"]["ssm_D"]),
                  dt_bias=jnp.ones_like(jp["layers"]["dt_bias"]))
    lever = {(arch, "float32"): (dict(jp, layers=layers), cfg)}
    got = {}
    for cd in ("float32", "bfloat16"):
        jm, jq, m, tp, _ = _models(jax_mesh, lever, arch, "float32", cd, 0)
        jl, tl = _serve(jm, jq, m, tp, decodes=0)[0]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=FP32_TOL, rtol=FP32_TOL)
        got[cd] = np.asarray(jl), tl.numpy()
    for pkg in (0, 1):
        a, b = got["float32"][pkg], got["bfloat16"][pkg]
        assert not np.allclose(b, a, atol=FP32_TOL, rtol=FP32_TOL), pkg
        assert np.linalg.norm(b - a) / np.linalg.norm(a) > FP32_TOL, pkg


@pytest.mark.parametrize("cd,chunk", KNOBS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knobs_match_the_reference(jax_mesh, weights, dtype, cd, chunk):
    check_knobs(jax_mesh, weights, ARCH, dtype, cd, chunk)


def test_bf16_compute_moves_both_packages(jax_mesh, weights):
    check_knob_moves(jax_mesh, weights, ARCH)


def test_rules_reach_the_scan(monkeypatch):
    """ssm_mix hands ssd_op the rules' chunk (or the config's) and compute
    dtype, as the reference's mamba_sublayer hands ssd_chunked its."""
    from repro_torch.models import model as model_mod
    seen = []
    real = model_mod.ssd_op

    def spy(*args, chunk, compute_dtype):
        seen.append((chunk, compute_dtype))
        return real(*args, chunk=chunk, compute_dtype=compute_dtype)

    monkeypatch.setattr(model_mod, "ssd_op", spy)
    cfg = reduced(get_config(ARCH))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    for knobs, want in (({}, (32, torch.float32)),
                        ({"ssm_chunk": 16, "ssd_compute_dtype": "bfloat16"},
                         (16, torch.bfloat16))):
        seen.clear()
        m = Model(cfg, single_device_rules(**knobs), device="cpu")
        m.prefill(m.init(torch.Generator().manual_seed(0)),
                  {"tokens": toks}, cache_len=16)
        assert seen == [want] * cfg.num_layers


# ------------------------------------- the card's bf16-intra instances ---

@pytest.fixture(scope="module")
def budget_case():
    """B = 2, S = 1024, H = 4, P = 64, N = 128 under the JAX tests' draws,
    x, B, C rounded to bf16; dy ~ N(0, 1) in bf16."""
    arrays = list(_inputs(2, 1024, 4, 64, 1, 128, seed=11))
    for i in (0, 3, 4):
        arrays[i] = torch.from_numpy(arrays[i]).bfloat16().float().numpy()
    dy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        arrays[0].shape).astype(np.float32)).bfloat16().float().numpy()
    return arrays, dy


def _jax_scan(arrays, dy, cd):
    """The reference's y and its six gradients (jax.grad of sum(y dy)) at
    compute dtype ``cd``, chunk 256, as numpy."""
    def y(*args):
        return jssm.ssd_chunked(*args, chunk=256, compute_dtype=cd)

    def loss(*args):
        return jnp.sum(y(*args) * dy)
    args = [jnp.asarray(a) for a in arrays]
    out = jax.jit(y)(*args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
    return (torch.from_numpy(np.array(out, np.float32)),
            [torch.from_numpy(np.array(g, np.float32)) for g in grads])


def _budget(ref_err: float, gate: float) -> float:
    """chip_smoke.py's [ssd knobs] budget: 1.5 x the reference's own
    bf16-vs-fp32 error, or the default instance's gate where that is
    larger (an output the knob leaves as it was)."""
    return max(KNOB_BUDGET * ref_err, gate)


def test_emulated_bf16_intra_forward_within_the_budget(budget_case):
    arrays, dy = budget_case
    y32, _ = _jax_scan(arrays, dy, jnp.float32)
    y16, _ = _jax_scan(arrays, dy, jnp.bfloat16)
    targs = [torch.from_numpy(a) for a in arrays]
    y1, st1 = _emulate_ssd_kernel(*targs, m_parts=1)
    y2, st2 = _emulate_ssd_kernel(*targs, m_parts=2)
    row = lambda a, r: row_rel_err(a, r, floor=GRAD_ROW_FLOOR)  # noqa: E731
    ref_err = row(y16, y32)
    assert 5e-2 < ref_err < 1e-1           # measured 7.6e-2
    assert row(y1, y32) <= _budget(ref_err, SSD_Y_ROW_RTOL)
    assert row(y1, y32) < ref_err          # measured 3.4e-2
    # the instance is not the default one: one bf16 part of M shows
    assert row(y1, y2) > SSD_Y_ROW_RTOL
    # the states keep both parts: the final state is the default's
    assert row_rel_err(st1, st2) <= SSD_STATE_ROW_RTOL / 10


def test_emulated_bf16_intra_backward_within_the_budget(budget_case):
    arrays, dy = budget_case
    _, g32 = _jax_scan(arrays, dy, jnp.float32)
    _, g16 = _jax_scan(arrays, dy, jnp.bfloat16)
    targs = [torch.from_numpy(a) for a in arrays]
    tdy = torch.from_numpy(dy)
    one = ssd_backward_tiles(*targs, tdy, split=True, hi_only=("m", "q"))
    two = ssd_backward_tiles(*targs, tdy, split=True)
    apart = 0.0
    for name, a, a2, r16, r32 in zip(GRAD_NAMES, one, two, g16, g32):
        if name in ("dx", "dB", "dC"):  # the kernel's bf16 outputs
            a, a2 = a.bfloat16(), a2.bfloat16()
        err = row_rel_err(a, r32, floor=GRAD_ROW_FLOOR)
        ref_err = row_rel_err(r16, r32, floor=GRAD_ROW_FLOOR)
        assert err <= _budget(ref_err, GRAD_ROW_RTOL), (name, err, ref_err)
        apart = max(apart, row_rel_err(a, a2, floor=GRAD_ROW_FLOOR))
    assert apart > SSD_Y_ROW_RTOL
