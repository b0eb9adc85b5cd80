"""The port's dense model against the JAX package's ``Model`` on tiny
qwen2.5-3b, with the reference's own weights carried across as numpy.

The reference runs on an Auto-axis (1, 1) mesh: the stock
``single_device_rules()`` builds Explicit axes, on which its sharding
constraints raise.

Tolerances: fp32 to 2e-4 (logits of order 1 after two layers of fp32
arithmetic summed in another order; measured ~1e-6); bf16 to 4e-2 (bf16
rounds at different places in the two frameworks).
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
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

FP32_TOL = 2e-4
BF16_TOL = 4e-2
ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def _pair(jax_rules, dtype: str, **overrides):
    """(JAX model, JAX params, port model, port params): same weights."""
    jcfg = jreduced(jget_config(ARCH), dtype=dtype, **overrides)
    jm = JModel(jcfg, jax_rules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype=dtype, **overrides)
    m = Model(cfg, device="cpu")
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@pytest.fixture(scope="module")
def fp32_pair(jax_rules):
    return _pair(jax_rules, "float32")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("cache_len", [32, 16, 24])  # S < W, S > W, S == W
def test_prefill_then_decode_matches_reference(fp32_pair, cache_len):
    jm, jp, m, tp = fp32_pair
    toks = _tokens(m.cfg.vocab_size, 2, 24)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       cache_len=cache_len)
    assert tl.dtype == torch.float32 and tl.shape == (2, m.cfg.vocab_size)
    _close(jl, tl, FP32_TOL)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        _close(jc[name], tc[name], FP32_TOL)
    np.testing.assert_array_equal(np.asarray(jc["slot_pos"]),
                                  tc["slot_pos"].numpy())
    pos = toks.shape[1]
    for _ in range(4):  # past S == W the ring wraps
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        pos += 1
        _close(jl, tl, FP32_TOL)
        _close(jc["k"], tc["k"], FP32_TOL)
        np.testing.assert_array_equal(np.asarray(jc["slot_pos"]),
                                      tc["slot_pos"].numpy())


def test_sliding_window_model_matches_reference(jax_rules):
    """A window narrower than the prompt bounds both attention and the
    cache (cache_window), in prefill and decode."""
    jm, jp, m, tp = _pair(jax_rules, "float32", sliding_window=8)
    assert m.cache_window(32) == jm.cache_window(32) == 8
    toks = _tokens(m.cfg.vocab_size, 2, 20, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=32)
    _close(jl, tl, FP32_TOL)
    jl, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jc, jnp.int32(20))
    tl, _ = m.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, 20)
    _close(jl, tl, FP32_TOL)


def test_bf16_prefill_matches_reference(jax_rules):
    jm, jp, m, tp = _pair(jax_rules, "bfloat16")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    toks = _tokens(m.cfg.vocab_size, 2, 16, seed=2)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, _ = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=32)
    assert tl.dtype == torch.float32
    _close(jl, tl, BF16_TOL)


def test_prefill_agrees_with_prefill_plus_decode(fp32_pair):
    """prefill(S) last logits == prefill(S-1) then decode_step(token S-1)."""
    _, _, m, tp = fp32_pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, 2, 12, seed=3))
    full, _ = m.prefill(tp, {"tokens": toks}, cache_len=16)
    _, cache = m.prefill(tp, {"tokens": toks[:, :-1]}, cache_len=16)
    step, _ = m.decode_step(tp, toks[:, -1:], cache, 11)
    torch.testing.assert_close(step, full, atol=FP32_TOL, rtol=FP32_TOL)


def test_init_draws_the_schema_distributions():
    cfg = reduced(get_config(ARCH), dtype="float32", num_layers=4)
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in p["layers"].values()) + sum(
        t.numel() for k, t in p.items() if k != "layers") == m.count_params()
    assert torch.all(p["layers"]["attn_norm"] == 1)
    assert torch.all(p["layers"]["bq"] == 0)
    assert abs(p["layers"]["wq"].std().item() - 0.02) < 2e-3
    assert abs(p["layers"]["wo"].std().item() - 0.02 / 8 ** 0.5) < 2e-3
    again = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], p["embed"])


@pytest.mark.parametrize("tied", [False, True])
def test_unembed_table_is_made_from_the_weights_given(tied):
    """The fp32 unembedding table is made from the params passed in, never
    kept: given or not, the logits agree, and weights changed in place
    change them."""
    cfg = reduced(get_config(ARCH), tie_embeddings=tied)
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    table = m.unembed_table(p)
    src = p["embed"].T if tied else p["lm_head"]
    assert table.dtype == torch.float32 and table.shape == src.shape
    assert torch.equal(table, src.float())
    toks = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, 8, seed=4))}
    with torch.no_grad():
        given, _ = m.prefill(p, toks, cache_len=16, unembed=table)
        made, cache = m.prefill(p, toks, cache_len=16)
        assert torch.equal(given, made)
        step, _ = m.decode_step(p, toks["tokens"][:, -1:], cache, 8)
        src.mul_(2)  # load new weights into the same tensor
        again, _ = m.decode_step(p, toks["tokens"][:, -1:], cache, 8)
    if not tied:  # a tied table also feeds the embedding: no simple ratio
        torch.testing.assert_close(again, 2 * step, rtol=1e-2, atol=1e-3)
    assert not torch.equal(again, step)


def test_params_from_numpy_rejects_a_wrong_layout(fp32_pair):
    jm, jp, m, _ = fp32_pair
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["wk"] = tree["layers"]["wk"].transpose(0, 2, 1)  # [out, in]
    with pytest.raises(ValueError, match="wk"):
        params_from_numpy(tree, m.cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_ported_families_are_accepted(arch):
    """Every family the JAX package runs: dense, MoE, SSM, hybrid and the
    frontend families (vlm, audio)."""
    cfg = get_config(arch)
    assert Model(cfg, device="cpu").cfg.arch_type == cfg.arch_type


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(reduced(get_config(ARCH)))


def test_config_is_a_copy_not_the_reference():
    cfg = get_config(ARCH)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
