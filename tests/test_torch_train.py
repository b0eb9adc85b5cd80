"""The port's training path against the JAX package's on tiny qwen2.5-3b:
the synthetic stream, the loader, the LR schedules, AdamW, ``train_loss``
and its gradients, the train step, the training loop and its CLI, and the
gradients of attention; with the reference's own weights carried across as
numpy. The flash backward kernel itself is held against its plain version
in tests/test_torch_kernels.py (on a card).

The reference runs on an Auto-axis (1, 1) mesh, always under ``jax.jit``:
eagerly, the layer scan inside its attention ``shard_map`` raises.

Tolerances: fp32 to 2e-4 (the model's losses and gradients after two
layers of fp32 arithmetic summed in another order; each gradient leaf's
absolute tolerance scaled by its largest entry); bf16 to 4e-2 (bf16 rounds
at different places in the two frameworks); AdamW alone to 2e-6 (the same
fp32 operations on one tree, rounded in another order by a few ulp);
attention gradients in fp32 to 1e-4 (sums over 64-256 keys).
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
from repro.data.synthetic import SyntheticStream as JStream
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.sharding.rules import make_rules
from repro.train.loop import train_loop as jtrain_loop
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config, get_tiny, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.data.loader import Loader
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.kernels.ops import attention_op
from repro_torch.launch import train as train_cli
from repro_torch.models import frontend
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedule
from repro_torch.train.loop import train_loop
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_train_step)

FP32_TOL = 2e-4
BF16_TOL = 4e-2
ADAMW_TOL = 2e-6
ATTN_GRAD_TOL = 1e-4
ARCH = "qwen2.5-3b"
B, S = 2, 16


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


def _leaves(jtree, ttree):
    """(name, jax leaf, torch leaf) over the reference's tree."""
    out = []
    for name in sorted(jtree):
        if isinstance(jtree[name], dict):
            out += [(f"{name}/{n}", j, t)
                    for n, j, t in _leaves(jtree[name], ttree[name])]
        else:
            out.append((name, jtree[name], ttree[name]))
    return out


def _close_leaf(name, j, t, tol, atol=0.0):
    j = np.asarray(j, np.float32)
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t.detach().float().numpy(), j, rtol=tol,
                               atol=max(tol * scale, atol), err_msg=name)


def _port_grads(m, tp, batch):
    grads = adamw.tree_map(torch.zeros_like, tp)
    loss, metrics = loss_and_grads(m, tp, batch, grads)
    return loss, metrics, grads


# ---------------------------------------------------------------- data ---

@pytest.mark.parametrize("vocab,seed,step", [(512, 0, 0), (512, 0, 7),
                                             (512, 3, 1), (1000, 11, 250),
                                             (151936, 0, 2)])
def test_synthetic_stream_is_bit_equal(vocab, seed, step):
    ours = SyntheticStream(vocab, seed).batch(step, 3, 33)
    ref = JStream(vocab, seed).batch(step, 3, 33)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_loader_splits_tokens_and_labels():
    stream = SyntheticStream(512, 4)
    out = Loader(stream, 3, 20, "cpu")(5)
    raw = JStream(512, 4).batch(5, 3, 20)
    assert set(out) == {"tokens", "labels"}
    for name, want in (("tokens", raw[:, :-1]), ("labels", raw[:, 1:])):
        assert out[name].dtype == torch.int32 and out[name].shape == (3, 20)
        np.testing.assert_array_equal(out[name].numpy(), want)


# ----------------------------------------------------------- schedules ---

COSINE = dict(peak_lr=3e-4, warmup=10, total=100, floor_frac=0.1)
WSD = dict(peak_lr=1e-3, warmup=10, stable=30, decay=40, floor_frac=0.05)


@pytest.mark.parametrize("name,step", [
    *(("cosine", s) for s in (0, 1, 9, 10, 11, 55, 99, 100, 150)),
    *(("wsd", s) for s in (0, 5, 10, 39, 40, 41, 60, 79, 80, 200))])
def test_schedule_matches_reference(name, step):
    kw = COSINE if name == "cosine" else WSD
    ours = getattr(schedule, f"{name}_schedule")(step, **kw)
    ref = getattr(jschedule, f"{name}_schedule")(step, **kw)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6, atol=0)
    # a step held as a 0-d int32 tensor, as the optimizer's state holds it
    ours_t = getattr(schedule, f"{name}_schedule")(
        torch.tensor(step, dtype=torch.int32), **kw)
    assert ours_t.item() == ours.item()


# --------------------------------------------------------------- AdamW ---

def _random_tree(rng, scale):
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32) * scale,
            "final_norm": rng.standard_normal(4).astype(np.float32) * scale,
            "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32) * scale,
                       "b": rng.standard_normal((3, 5)).astype(np.float32) * scale}}


@pytest.mark.parametrize("clipped", [True, False])
def test_adamw_matches_reference(clipped):
    """Three steps with fresh gradients each; their global norm is ~4x the
    clip (clipping active) or ~0.1x (inactive)."""
    rng = np.random.default_rng(int(clipped))
    cfg = adamw.AdamWConfig()
    jcfg = jadamw.AdamWConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    p0 = _random_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = adamw.tree_map(torch.from_numpy, jax.tree.map(np.copy, p0))
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    g_scale = 0.5 if clipped else 0.012
    for _ in range(3):
        g = _random_tree(rng, g_scale)
        # the reference gets its own copy: jnp.asarray may alias the numpy
        # buffer, which the port's in-place clip rewrites while the jitted
        # update may still be reading it
        jp, js, jm = jax.jit(jadamw.adamw_update, static_argnums=3)(
            jp, jax.tree.map(jnp.array, g), js, jcfg)
        ids = id(tp), id(ts)
        tp, ts, tm = adamw.adamw_update(
            tp, adamw.tree_map(torch.from_numpy, g), ts, cfg)
        assert (id(tp), id(ts)) == ids
        assert (float(jm["grad_norm"]) > cfg.grad_clip) == clipped
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=ADAMW_TOL)
        for part, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                             ("nu", js["nu"], ts["nu"])):
            for name, j, t in _leaves(jt, tt):
                _close_leaf(f"{part}/{name}", j, t, ADAMW_TOL)
        assert ts["step"].item() == int(js["step"])


def test_adamw_update_needs_one_temporary_per_leaf():
    """The update allocates at most one leaf-sized tensor at a time (the
    reference's functional form makes about seven): measured by the
    allocator's peak over a large leaf, on the CPU through torch's
    profiler memory events."""
    p = {"w": torch.randn(256, 1024)}
    g = {"w": torch.randn(256, 1024)}
    s = adamw.adamw_init(p)
    leaf = p["w"].numel() * 4
    with torch.profiler.profile(profile_memory=True) as prof:
        adamw.adamw_update(p, g, s, adamw.AdamWConfig())
    allocs = [e.cpu_memory_usage for e in prof.events()
              if e.cpu_memory_usage and e.cpu_memory_usage > 0]
    assert sum(a for a in allocs if a >= leaf) <= leaf


# ------------------------------------------------------------ the loss ---

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
    assert tp["layers"]["wq"].dtype == torch.float32
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
    the same as autograd through the stacked leaves."""
    _, _, m, tp = fp32_pair
    _, tb = _batch(m.cfg.vocab_size, step=3)
    _, _, grads = _port_grads(m, tp, tb)
    leaves = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
    m.train_loss(leaves, tb)[0].backward()
    for name, t in leaves["layers"].items():
        torch.testing.assert_close(grads["layers"][name], t.grad, rtol=1e-6,
                                   atol=1e-7)
    torch.testing.assert_close(grads["embed"], leaves["embed"].grad)


def test_fp32_masters_serve_like_cast_parameters(jax_rules):
    """Every use casts to the compute dtype: prefill over fp32 masters is
    bit-equal to prefill over the same parameters cast once."""
    _, _, m, tp = _pair(jax_rules, "bfloat16")
    cast = adamw.tree_map(lambda t: t.to(torch.bfloat16), tp)
    toks = torch.from_numpy(JStream(m.cfg.vocab_size, 0).batch(0, 2, 12))
    with torch.no_grad():
        a, _ = m.prefill(tp, {"tokens": toks}, cache_len=16)
        b, _ = m.prefill(cast, {"tokens": toks}, cache_len=16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b",
                                  "audio+moe"])
def test_train_loss_runs_the_frontend_families(arch):
    """A train step's loss and gradients of each frontend family, from
    stand-in embeddings (with text-like M-RoPE positions for qwen2-vl):
    finite, and the unused ``embed`` leaf's gradient zero. Their parity
    with the reference is in tests/test_torch_frontend_train.py."""
    if arch == "audio+moe":
        cfg = reduced(get_config("musicgen-large"),
                      moe=MoEConfig(num_experts=4, experts_per_token=2))
    else:
        cfg = get_tiny(arch)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    batch = {"embeddings": frontend.fake_embeddings(cfg, 2, 8, gen, "cpu"),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    if cfg.mrope:
        batch["mrope_pos"] = frontend.fake_mrope_pos(cfg, 2, 8, "cpu")
    loss, metrics, grads = _port_grads(m, params, batch)
    assert torch.isfinite(loss) and torch.isfinite(metrics["aux"])
    assert (metrics["aux"].item() > 0) == (arch == "audio+moe")
    assert torch.count_nonzero(grads["embed"]) == 0
    assert all(torch.isfinite(t).all() for t in adamw.tree_leaves(grads))
    assert torch.count_nonzero(grads["layers"]["wq"]) > 0


def test_apply_layers_runs_train_mode_only(fp32_pair):
    _, _, m, tp = fp32_pair
    h = torch.zeros((1, 4, m.cfg.d_model))
    with pytest.raises(ValueError, match="train"):
        m.apply_layers(tp, h, mode="prefill", positions=torch.arange(4))


# ------------------------------------------------------------ the step ---

@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_train_step_matches_reference(fp32_pair, lr):
    """Three steps of make_train_step: params, mu, nu, step and the
    metrics. The parameters are also allowed 1% of the largest move Adam
    can make over the steps (the sum of their learning rates): Adam
    normalises each element, so an element whose gradient is near the fp32
    noise of the loss (the k bias's, which the softmax nearly cancels:
    ~1e-2 relative error against the reference) takes an update off by
    that much, while mu and nu stay within 2e-4."""
    jm, jp, m, tp = fp32_pair
    tp = adamw.tree_map(torch.clone, tp)
    kw = dict(peak_lr=1e-3, warmup=2, total=10)
    jlr = (lambda s: jschedule.cosine_schedule(s, **kw)) if lr == "cosine" else None
    tlr = (lambda s: schedule.cosine_schedule(s, **kw)) if lr == "cosine" else None
    jstep = jax.jit(jmake_train_step(jm, jadamw.AdamWConfig(), jlr))
    tstep = make_train_step(m, adamw.AdamWConfig(), tlr)
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    moved = 0.0
    for step in range(3):
        jb, tb = _batch(m.cfg.vocab_size, step)
        jp, js, jmet = jstep(jp, js, jb)
        ids = id(tp), id(ts)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert (id(tp), id(ts)) == ids
        assert set(tmet) == set(jmet) == {"loss", "ce", "aux", "lr",
                                          "grad_norm"}
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


def test_init_train_state_keeps_fp32_masters():
    m = Model(get_tiny(ARCH), device="cpu")
    st = init_train_state(m, torch.Generator().manual_seed(0))
    assert m.compute_dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in adamw.tree_leaves(st.params))
    assert st.opt["step"].item() == 0 and st.step == 0
    assert all(torch.count_nonzero(t) == 0
               for t in adamw.tree_leaves(st.opt["mu"]))


# ------------------------------------------------------------ the loop ---

def test_train_loop_history_matches_reference(jax_rules):
    jm, jp, m, tp = _pair(jax_rules, "float32")
    _, _, jhist = jtrain_loop(jm, batch=B, seq_len=S, steps=5, log_every=2,
                              log_fn=lambda _: None,
                              params=jax.tree.map(jnp.copy, jp))
    logs = []
    _, _, hist = train_loop(m, batch=B, seq_len=S, steps=5, log_every=2,
                            log_fn=logs.append, params=tp)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 2, 4]
    assert len(logs) == 3
    for h, jh in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=FP32_TOL)
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"],
                                   rtol=FP32_TOL)
        assert h["t"] >= 0


@pytest.mark.parametrize("kw", [{"checkpointer": object()}, {"ckpt_every": 2},
                                {"full_every": 3}, {"resume_from": 4},
                                {"restore_specs": {}}, {"restore_coords": {}},
                                {"restore_sched": object()}],
                         ids=lambda kw: next(iter(kw)))
def test_train_loop_refuses_checkpointing(kw):
    """Each checkpoint option alone cannot act (no checkpointer to save to
    or restore from, nothing to restore, or an object that is no
    checkpointer): the loop refuses it by name rather than train without
    it. The options themselves are tested in tests/test_torch_ckpt.py."""
    m = Model(get_tiny(ARCH), device="cpu")
    with pytest.raises((ValueError, TypeError), match=next(iter(kw))):
        train_loop(m, batch=1, seq_len=8, steps=1, **kw)


def test_train_cli_loss_falls_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "12", "--batch", "2",
                    "--seq-len", "32"])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and "qwen2.5-3b-tiny" in done[0]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert last < first


def test_train_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--steps", "1"])


# ------------------------------------------------- attention gradients ---

@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (2, 4, 2, 64, 32, 0),     # causal, GQA 2:1
    (1, 4, 2, 96, 32, 16),    # sliding window
    (1, 8, 1, 80, 16, 0),     # MQA
    (2, 4, 4, 64, 32, 0),     # a group of 1
], ids=["causal", "window", "gqa", "group1"])
def test_attention_op_grads_match_jax(b, hq, hkv, s, d, window):
    """attention_op's plain path differentiated by autograd against
    jax.grad of the JAX model's chunked_attention, in fp32."""
    rng = np.random.default_rng(s + d + window)
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    pos = jnp.arange(s, dtype=jnp.int32)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, pos, pos, window=window,
                                      q_chunk=32, k_chunk=32)
        return jnp.sum(out * do)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention_op(*leaves, causal=True, window=window)
    (out * torch.from_numpy(do)).sum().backward()
    for name, j, t in zip("qkv", jg, leaves):
        _close_leaf(f"d{name}", j, t.grad, ATTN_GRAD_TOL)
