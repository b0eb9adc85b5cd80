"""The port's Mamba2 (SSM) family against the JAX package's ``Model`` on
tiny mamba2-370m, with the reference's own weights carried across as numpy.

The reference runs on an Auto-axis (1, 1) mesh, as in test_torch_model.py.
Tolerances: fp32 to 2e-4 (logits of order 1 after two layers of fp32
arithmetic summed in another order; measured ~1e-6); bf16 to 4e-2 (bf16
rounds at different places in the two frameworks; measured ~1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model, param_schema

FP32_TOL = 2e-4
BF16_TOL = 4e-2
ARCH = "mamba2-370m"
CACHE_LEAVES = ("ssm", "conv_x", "conv_B", "conv_C")
# the leaves the reference uses in fp32 whatever the compute dtype
FP32_LEAVES = ("A_log", "ssm_D", "dt_bias", "conv_x_w", "conv_x_b",
               "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b")


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def _pair(jax_rules, dtype: str, **overrides):
    """(JAX model, JAX params, port model, port params): same weights."""
    jm = JModel(jreduced(jget_config(ARCH), dtype=dtype, **overrides),
                jax_rules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype=dtype, **overrides)
    m = Model(cfg, device="cpu")
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@pytest.fixture(scope="module")
def fp32_pair(jax_rules):
    return _pair(jax_rules, "float32")


@pytest.fixture(scope="module")
def bf16_pair(jax_rules):
    return _pair(jax_rules, "bfloat16")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("s", [40, 100, 7])  # 2 chunks; padded; < chunk
def test_prefill_then_decode_matches_reference(fp32_pair, s):
    jm, jp, m, tp = fp32_pair
    toks = _tokens(m.cfg.vocab_size, 2, s, seed=s)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=128)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=128)
    assert tl.dtype == torch.float32 and tl.shape == (2, m.cfg.vocab_size)
    assert set(tc) == set(jc) == set(CACHE_LEAVES)
    _close(jl, tl, FP32_TOL)
    for name in CACHE_LEAVES:
        assert tc[name].shape == jc[name].shape
        _close(jc[name], tc[name], FP32_TOL)
    for pos in range(s, s + 3):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        _close(jl, tl, FP32_TOL)
        for name in CACHE_LEAVES:
            _close(jc[name], tc[name], FP32_TOL)


def test_bf16_prefill_and_decode_match_reference(bf16_pair):
    jm, jp, m, tp = bf16_pair
    toks = _tokens(m.cfg.vocab_size, 2, 48, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=64)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=64)
    assert tl.dtype == torch.float32
    assert tc["ssm"].dtype == torch.float32
    assert all(tc[n].dtype == torch.bfloat16 for n in CACHE_LEAVES[1:])
    _close(jl, tl, BF16_TOL)
    nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    jl, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(48))
    tl, _ = m.decode_step(tp, torch.from_numpy(nxt), tc, 48)
    _close(jl, tl, BF16_TOL)


def test_fp32_leaves_stay_fp32_and_bit_equal(bf16_pair):
    """In a bf16 model the leaves the reference reads in fp32 keep their
    fp32 bits; the others are cast once to bf16."""
    _, jp, _, tp = bf16_pair
    for name, t in tp["layers"].items():
        ref = np.asarray(jp["layers"][name])
        if name in FP32_LEAVES:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
        else:
            assert t.dtype == torch.bfloat16, name
    schema = param_schema(reduced(get_config(ARCH)))["layers"]
    assert {n for n, leaf in schema.items() if leaf.fp32} == set(FP32_LEAVES)


def test_init_keeps_fp32_leaves_and_draws_the_schema_distributions():
    cfg = reduced(get_config(ARCH), num_layers=4)
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    lay = p["layers"]
    assert {n for n, t in lay.items() if t.dtype == torch.float32} == set(
        FP32_LEAVES)
    assert p["embed"].dtype == torch.bfloat16
    a = torch.exp(lay["A_log"])
    assert a.min() >= 1.0 and a.max() <= 16.0
    dt = torch.nn.functional.softplus(lay["dt_bias"])
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert torch.all(lay["ssm_D"] == 1) and torch.all(lay["conv_x_b"] == 0)
    assert abs(lay["conv_x_w"].std().item() - 0.2) < 2e-2
    assert abs(lay["out_proj"].float().std().item() - 0.02 / 8 ** 0.5) < 2e-3


def test_count_params_equals_the_schema_and_reference(jax_rules, fp32_pair):
    jm, jp, m, tp = fp32_pair
    n = sum(t.numel() for t in tp["layers"].values()) + sum(
        t.numel() for k, t in tp.items() if k != "layers")
    assert m.count_params() == n == jm.count_params()
    full = JModel(jget_config(ARCH), jax_rules).count_params()
    assert Model(get_config(ARCH), device="cpu").count_params() == full


def test_prefill_agrees_with_prefill_plus_decode(fp32_pair):
    """prefill(S) last logits == prefill(S-1) then decode_step(token S-1):
    the scan's final state hands over to the recurrence."""
    _, _, m, tp = fp32_pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, 2, 45, seed=3))
    full, _ = m.prefill(tp, {"tokens": toks}, cache_len=64)
    _, cache = m.prefill(tp, {"tokens": toks[:, :-1]}, cache_len=64)
    step, _ = m.decode_step(tp, toks[:, -1:], cache, 44)
    torch.testing.assert_close(step, full, atol=FP32_TOL, rtol=FP32_TOL)


def test_cache_shapes_match_reference(fp32_pair):
    jm, _, m, _ = fp32_pair
    assert m.cache_shapes(3, 99) == jm.cache_shapes(3, 99)
    caches = m.init_cache(3, 99)
    assert caches["ssm"].dtype == torch.float32
    assert all(not t.any() for t in caches.values())


def test_params_from_numpy_rejects_a_transposed_x_proj(fp32_pair):
    _, jp, m, _ = fp32_pair
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["x_proj"] = tree["layers"]["x_proj"].transpose(0, 2, 1)
    with pytest.raises(ValueError, match="x_proj"):
        params_from_numpy(tree, m.cfg, device="cpu")


def test_params_from_numpy_rejects_a_missing_leaf(fp32_pair):
    _, jp, m, _ = fp32_pair
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["gate_norm"]
    with pytest.raises(ValueError, match="gate_norm"):
        params_from_numpy(tree, m.cfg, device="cpu")
