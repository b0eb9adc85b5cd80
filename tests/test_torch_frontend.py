"""The frontend families against the JAX package: M-RoPE, the frontend
stand-ins, and the serving path of tiny qwen2-vl-72b (vlm, M-RoPE) and
tiny musicgen-large (audio, MHA) from stand-in embeddings, with the
reference's own weights carried across as numpy.

qwen2-vl's prefills take vision-grid positions (``vision_grid_pos``):
text, then an image of 2 frames x 4 x 4 patches whose tokens take (t, h,
w) over the grid, then text from the largest position + 1, as Qwen2-VL
lays them out. Text-like positions would hide a wrong section split,
since M-RoPE then equals RoPE.

The reference runs on an Auto-axis (1, 1) mesh. Tolerances: fp32 to 2e-4
(logits of order 1 after two layers summed in another order); bf16 to
4e-2 (bf16 rounds at different places in the two frameworks); M-RoPE
alone as ``apply_rope`` in tests/test_torch_layers.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import frontend as jfrontend
from repro.models import layers as jL
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules
from repro_torch.ckpt.checkpoint import flat_with_names
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.models import frontend
from repro_torch.models import layers as tL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import adamw

FP32_TOL = 2e-4
BF16_TOL = 4e-2
ROPE_TOL = {"float32": 2e-5, "bfloat16": 4e-2}
VLM, AUDIO = "qwen2-vl-72b", "musicgen-large"
# (name, arch, overrides of reduced(); "moe" as (experts, top k)); the
# MoE case at capacity factor 8, where nothing is dropped
CASES = {VLM: (VLM, {}), AUDIO: (AUDIO, {}),
         "audio+moe": (AUDIO, {"moe": (4, 2)})}
NO_DROP_CF = 8.0


def vision_grid_pos(b: int, s: int, grid=(2, 4, 4), start: int = 4):
    """[b, s, 3] int32 M-RoPE positions: ``start`` text tokens (all three
    streams the token index), an image of t x h x w patches whose tokens
    take (start + t, start + h, start + w), then text going on from the
    largest position + 1 on all three streams."""
    t, h, w = grid
    n = t * h * w
    assert start + n <= s
    pos = np.empty((s, 3), np.int32)
    pos[:start] = np.arange(start)[:, None]
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    pos[start:start + n] = start + np.stack(
        [tt.ravel(), hh.ravel(), ww.ravel()], -1)
    after = s - start - n
    nxt = start + max(grid)
    pos[start + n:] = (nxt + np.arange(after))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def text_pos(b: int, s: int):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None, :, None],
                           (b, s, 3)).copy()


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def configs(case: str, dtype: str):
    """(reference config, port config) of a case: the same fields."""
    arch, over = CASES[case]
    out = []
    for get, red, moe_cls in ((jconfigs.get_config, jconfigs.reduced,
                               JMoEConfig),
                              (get_config, reduced, MoEConfig)):
        kw = dict(over, dtype=dtype)
        if "moe" in kw:
            kw["moe"] = moe_cls(*kw["moe"], capacity_factor=NO_DROP_CF)
        out.append(red(get(arch), **kw))
    return out


@pytest.fixture(scope="module")
def pairs(jax_rules):
    """pairs(case, dtype, masters) -> (JAX model, JAX params, port model,
    port params): the same weights, made once per case, dtype and
    parameter dtype (fp32 masters, or the compute dtype) in this module."""
    made = {}

    def pair(case, dtype="float32", masters=False):
        if (case, dtype, masters) not in made:
            jcfg, cfg = configs(case, dtype)
            jm = JModel(jcfg, jax_rules)
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu",
                                   dtype=torch.float32 if masters else None)
            made[case, dtype, masters] = jm, jp, Model(cfg, device="cpu"), tp
        return made[case, dtype, masters]

    return pair


def inputs(cfg, b: int, s: int, *, seed: int = 0, grid: bool = True):
    """(reference batch, port batch): stand-in embeddings from a numpy
    seed, with vision-grid (or text-like) M-RoPE positions for a config
    with M-RoPE."""
    emb = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    batch = {"embeddings": emb}
    if cfg.mrope:
        batch["mrope_pos"] = vision_grid_pos(b, s) if grid else text_pos(b, s)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


# -------------------------------------------------------------- M-RoPE ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["text", "grid", "random"])
@pytest.mark.parametrize("sections", [(16, 24, 24), (8, 12, 12)],
                         ids=["full", "tiny"])
def test_apply_mrope_matches_reference(sections, where, dtype):
    dh = 2 * sum(sections)
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 48, 3, dh)).astype(np.float32)
    pos = {"text": text_pos(2, 48), "grid": vision_grid_pos(2, 48),
           "random": rng.integers(0, 4000, (2, 48, 3)).astype(np.int32)
           }[where]
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = tL.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    # fp32 angles up to ~4000 rad: cos/sin agree to a few ulps of the angle
    tol = max(ROPE_TOL[dtype], 1e-4) if where == "random" else ROPE_TOL[dtype]
    _close(jL.apply_mrope(xj, jnp.asarray(pos), 1e6, sections), out, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sections", [(16, 24, 24), (8, 12, 12)],
                         ids=["full", "tiny"])
def test_apply_mrope_with_text_positions_is_apply_rope(sections, dtype):
    """All three streams equal to the token index: the same floats as
    RoPE's, bit for bit; a grid's positions differ from it."""
    dh = 2 * sum(sections)
    x = torch.randn((2, 40, 4, dh), generator=torch.Generator().manual_seed(
        dh)).to(dtype)
    out = tL.apply_mrope(x, torch.from_numpy(text_pos(2, 40)), 1e6, sections)
    assert torch.equal(out, tL.apply_rope(x, torch.arange(40), 1e6))
    grid = tL.apply_mrope(x, torch.from_numpy(vision_grid_pos(2, 40)), 1e6,
                          sections)
    assert not torch.equal(grid, out)


def test_apply_mrope_sections_must_cover_half_the_head():
    x = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="sections"):
        tL.apply_mrope(x, torch.zeros((1, 4, 3), dtype=torch.int32), 1e4,
                       (8, 12, 8))


def test_each_section_rotates_by_its_own_stream():
    """Moving only the height stream changes only the height section's
    frequency slots (both halves of the rotation)."""
    sections = (8, 12, 12)
    x = torch.randn((1, 6, 2, 64), generator=torch.Generator().manual_seed(3))
    pos = torch.from_numpy(text_pos(1, 6))
    moved = pos.clone()
    moved[..., 1] += 5
    a = tL.apply_mrope(x, pos, 1e4, sections)
    b = tL.apply_mrope(x, moved, 1e4, sections)
    diff = (a != b).any(0).any(0).any(0)  # [Dh]
    slots = torch.zeros(32, dtype=torch.bool)
    slots[8:20] = True
    assert torch.equal(diff, torch.cat([slots, slots]))


# ------------------------------------------------------------ frontend ---

@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_helpers_match_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert frontend.needs_embeddings(cfg) == jfrontend.needs_embeddings(jcfg)
    assert frontend.needs_embeddings(cfg) == (arch in (VLM, AUDIO))
    e = jfrontend.embedding_spec(jcfg, 3, 17)
    assert frontend.embedding_shape(cfg, 3, 17) == e.shape
    p = jfrontend.mrope_pos_spec(jcfg, 3, 17)
    assert frontend.mrope_pos_shape(cfg, 3, 17) == p.shape


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_fake_inputs_shapes_dtypes_and_seed(arch):
    cfg = reduced(get_config(arch))
    emb = frontend.fake_embeddings(cfg, 2, 9, torch.Generator().manual_seed(1),
                                   "cpu")
    assert emb.dtype == torch.float32 and emb.shape == (2, 9, cfg.d_model)
    again = frontend.fake_embeddings(cfg, 2, 9,
                                     torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(emb, again)
    assert abs(emb.std().item() - 1) < 0.1
    pos = frontend.fake_mrope_pos(cfg, 2, 9, "cpu")
    assert pos.dtype == torch.int32 and pos.shape == (2, 9, 3)
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jfrontend.fake_mrope_pos(cfg, 2, 9)))


# ------------------------------------------------------------- schema ---

@pytest.mark.parametrize("arch,n", [(VLM, 72_706_203_648),
                                    (AUDIO, 3_229_812_736)])
def test_full_config_counts_the_references_parameters(jax_rules, arch, n):
    """At full width, on the meta device: the schema's leaves add up to the
    reference's ``count_params``."""
    cfg = get_config(arch)
    m = Model(cfg, device="cpu")
    meta = m.init_like(dtype=torch.float32)
    assert sum(t.numel() for t in adamw.tree_leaves(meta)) == m.count_params()
    assert m.count_params() == n
    assert JModel(jconfigs.get_config(arch), jax_rules).count_params() == n
    assert ("bq" in meta["layers"]) == (arch == VLM)


@pytest.mark.parametrize("case", list(CASES))
def test_params_from_numpy_carries_the_references_tree(pairs, case):
    """The reference's tree under its names (keystr, as checkpoints name
    them) and shapes, bit for bit in fp32: qwen2-vl's QKV biases are the
    leaves qwen2.5-3b has; nothing new."""
    _, jp, m, tp = pairs(case, masters=True)
    ref = [(jax.tree_util.keystr(path), x) for path, x in
           jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [n for n, _ in flat_with_names(tp)] == [n for n, _ in ref]
    for (name, j), t in zip(ref, adamw.tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert m.count_params() == sum(t.numel() for t in adamw.tree_leaves(tp))


# ------------------------------------------------------------ serving ---

def _prefill_decode(jm, jp, m, tp, jb, tb, tol, *, cache_len=64, steps=4):
    b, s = next(iter(tb.values())).shape[:2]
    jl, jc = jm.prefill(jp, jb, cache_len=cache_len)
    tl, tc = m.prefill(tp, tb, cache_len=cache_len)
    assert tl.dtype == torch.float32 and tl.shape == (b, m.cfg.vocab_size)
    _close(jl, tl, tol)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        _close(jc[name], tc[name], tol)
    np.testing.assert_array_equal(np.asarray(jc["slot_pos"]),
                                  tc["slot_pos"].numpy())
    for pos in range(s, s + steps):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        _close(jl, tl, tol)
        _close(jc["k"], tc["k"], tol)


@pytest.mark.parametrize("cache_len", [64, 32])   # S < W; S > W: ring wraps
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_from_embeddings_then_decode_matches_reference(pairs, case,
                                                                cache_len):
    jm, jp, m, tp = pairs(case)
    jb, tb = inputs(m.cfg, 2, 40, seed=1)
    _prefill_decode(jm, jp, m, tp, jb, tb, FP32_TOL, cache_len=cache_len)


@pytest.mark.parametrize("case", [VLM, AUDIO])
def test_bf16_prefill_from_embeddings_then_decode_matches_reference(pairs,
                                                                     case):
    jm, jp, m, tp = pairs(case, "bfloat16")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    jb, tb = inputs(m.cfg, 2, 40, seed=2)
    _prefill_decode(jm, jp, m, tp, jb, tb, BF16_TOL)


@pytest.mark.parametrize("case", [VLM, AUDIO])
def test_prefill_from_tokens_matches_reference(pairs, case):
    """The serving engine's path: tokens, plain RoPE (no mrope_pos)."""
    jm, jp, m, tp = pairs(case)
    toks = np.random.default_rng(3).integers(
        0, m.cfg.vocab_size, (2, 24)).astype(np.int32)
    _prefill_decode(jm, jp, m, tp, {"tokens": jnp.asarray(toks)},
                    {"tokens": torch.from_numpy(toks)}, FP32_TOL, steps=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [VLM, AUDIO])
def test_embeddings_of_the_tokens_prefill_as_the_tokens(pairs, case, dtype):
    """prefill({"embeddings": embed(tokens) in fp32, text-like
    mrope_pos}) is bit-equal to prefill({"tokens": tokens}): the cast
    comes before the first layer and text-like M-RoPE is RoPE."""
    _, _, m, tp = pairs(case, dtype)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, m.cfg.vocab_size, (2, 24)).astype(np.int32))
    batch = {"embeddings": tp["embed"][toks.long()].float()}
    if m.cfg.mrope:
        batch["mrope_pos"] = frontend.fake_mrope_pos(m.cfg, 2, 24, "cpu")
    a, ca = m.prefill(tp, batch, cache_len=32)
    b, cb = m.prefill(tp, {"tokens": toks}, cache_len=32)
    assert torch.equal(a, b)
    assert all(torch.equal(ca[k], cb[k]) for k in ca)


def test_vision_positions_change_the_logits(pairs):
    """The grid's positions reach the model: they give other logits than
    text-like positions on the same embeddings."""
    _, _, m, tp = pairs(VLM)
    _, grid = inputs(m.cfg, 2, 40, seed=5)
    _, text = inputs(m.cfg, 2, 40, seed=5, grid=False)
    a, _ = m.prefill(tp, grid, cache_len=64)
    b, _ = m.prefill(tp, text, cache_len=64)
    assert (a - b).abs().max() > 1e-3


def test_decode_takes_pos_on_all_three_streams(pairs, monkeypatch):
    """decode_step rotates the new token by M-RoPE at (pos, pos, pos), as
    the reference's does, even after a vision prefill."""
    _, _, m, tp = pairs(VLM)
    _, tb = inputs(m.cfg, 2, 40, seed=6)
    _, cache = m.prefill(tp, tb, cache_len=64)
    seen = []
    inner = tL.apply_mrope

    def spy(x, positions, theta, sections):
        seen.append(positions.clone())
        return inner(x, positions, theta, sections)

    monkeypatch.setattr(tL, "apply_mrope", spy)
    m.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32), cache, 40)
    assert len(seen) == 2 * m.cfg.num_layers
    for p in seen:
        assert p.shape == (2, 1, 3) and torch.all(p == 40)


def test_prefill_takes_its_shape_from_the_embeddings(pairs):
    _, _, m, tp = pairs(AUDIO)
    _, tb = inputs(m.cfg, 3, 17, seed=7)
    logits, cache = m.prefill(tp, tb, cache_len=32)
    assert logits.shape == (3, m.cfg.vocab_size)
    assert cache["k"].shape[1] == 3
    assert cache["slot_pos"][0, :17].tolist() == list(range(17))
