"""The port's hybrid family (Zamba2: a Mamba2 backbone with one shared
attention block run before every ``shared_attention_every``-th layer)
against the JAX package's ``_apply_hybrid``, on tiny zamba2-1.2b with five
layers, so that the shared block runs three times (layers 0, 2, 4), its
window of 64 below the prompts of 80-100 tokens, so that the ring wraps:
``prefill``'s logits and every cache leaf, three ``decode_step``s,
``train_loss`` and every gradient leaf (``shared_attn``'s, summed over
its three calls, among them), the train step, ``train_loop``, and both
launchers. The reference's own weights are carried across as numpy.

The reference runs on an Auto-axis (1, 1) mesh, always under ``jax.jit``,
as in tests/test_torch_train_ssm.py. Inputs are made from a seed with
numpy.

Tolerances are the repo's: fp32 to 2e-4 of each leaf's largest entry
(a few layers of fp32 arithmetic summed in another order; measured
~1e-6), bf16 to 4e-2 by each leaf's relative L2 error (bf16 rounds at
different places in the two frameworks).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.synthetic import SyntheticStream as JStream
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.sharding.rules import make_rules
from repro.train.loop import train_loop as jtrain_loop
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.ckpt.checkpoint import flat_with_names
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import SSM_CACHE, KV_CACHE, Model, param_schema
from repro_torch.optim import adamw
from repro_torch.train.loop import train_loop
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_train import _close_leaf, _leaves

FP32_TOL = 2e-4
BF16_TOL = 4e-2
ARCH = "zamba2-1.2b"
LAYERS = 5            # shared calls before layers 0, 2 and 4
B, S = 2, 80          # training: past the window of 64


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


def _pair(jax_rules, dtype: str, **port_kw):
    """(JAX model, JAX params, port model, port fp32 masters): the same
    weights."""
    jm = JModel(jreduced(jget_config(ARCH), dtype=dtype, num_layers=LAYERS),
                jax_rules)
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(ARCH), dtype=dtype, num_layers=LAYERS)
    m = Model(cfg, device="cpu", **port_kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                           dtype=torch.float32)
    return jm, jp, m, tp


@pytest.fixture(scope="module")
def fp32_pair(jax_rules):
    return _pair(jax_rules, "float32")


def _tokens(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


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


def _flat_cache(jcache) -> dict:
    """The reference's (mamba_caches, attn_caches) as the port's one dict."""
    mamba, attn = jcache
    return {**mamba, **attn}


def _assert_caches(jcache, tcache, tol, *, rel_l2: bool = False):
    ref = _flat_cache(jcache)
    assert set(ref) == set(tcache) == set(SSM_CACHE + KV_CACHE)
    for name, j in ref.items():
        t = tcache[name]
        assert tuple(t.shape) == j.shape, name
        if name == "slot_pos":
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        elif rel_l2:
            j = np.asarray(j, np.float32)
            err = np.linalg.norm(t.float().numpy() - j) / np.linalg.norm(j)
            assert err <= tol, (name, err)
        else:
            _close_leaf(name, j, t, tol)


def _close_rel(j, t, tol):
    j = np.asarray(j, np.float32)
    err = np.linalg.norm(t.float().numpy() - j) / max(np.linalg.norm(j), 1e-30)
    assert err <= tol, err


# --------------------------------------------------------- the schema ---

def test_full_config_counts_the_references_parameters():
    """At full width: the schema's leaves (on the meta device, no memory)
    add up to the reference's ``count_params`` (its schema) and to
    ``cfg.param_count()`` plus what that formula leaves out for a Mamba2
    layer, the gate norm [di] and the conv biases [di + 2 G N]."""
    cfg = get_config(ARCH)
    m = Model(cfg, device="cpu")
    meta = m.init_like(dtype=torch.float32)
    assert all(t.device.type == "meta" for t in adamw.tree_leaves(meta))
    n = sum(t.numel() for t in adamw.tree_leaves(meta))
    s = cfg.ssm
    di, gn = s.expand * cfg.d_model, s.ngroups * s.state_dim
    assert m.count_params() == n == 1_120_140_160
    assert n == cfg.param_count() + cfg.num_layers * (2 * di + 2 * gn)
    assert cfg.param_count() == 1_119_824_000
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    assert JModel(jget_config(ARCH), make_rules(mesh)).count_params() == n
    # the shared block once, unstacked
    assert {k: tuple(t.shape) for k, t in meta["shared_attn"].items()} == {
        "attn_norm": (2048,), "wq": (2048, 2048), "wk": (2048, 2048),
        "wv": (2048, 2048), "wo": (2048, 2048)}
    assert sum(t.numel() for t in meta["shared_attn"].values()) == 16_779_264


def test_schedule_runs_the_shared_block_every_sixth_layer():
    """Full width: 38 Mamba2 layers and the shared block before layers 0,
    6, ..., 36, seven calls, call j writing ring j."""
    cfg = get_config(ARCH)
    m = Model(cfg, device="cpu")
    sched = m._schedule(m.init_like())
    attn = [(n, i) for n, (kind, _, i) in enumerate(sched) if kind == "attn"]
    assert [i for _, i in attn] == list(range(7))
    layers = [i for kind, _, i in sched if kind == "mamba"]
    assert layers == list(range(38))
    # each call sits just before layer 6 j
    assert [sched[n + 1][2] for n, _ in attn] == [6 * j for j in range(7)]
    assert m.cache_shapes(8, 8192)["k"] == (7, 8, 4096, 32, 64)
    assert m.cache_shapes(8, 8192)["ssm"] == (38, 8, 64, 64, 64)


def test_params_from_numpy_carries_the_references_tree(fp32_pair):
    """The reference's tree, shared block included, under the reference's
    names (keystr, as the checkpoints name them) and shapes, bit for bit
    in fp32."""
    _, jp, m, tp = fp32_pair
    names = [n for n, _ in flat_with_names(tp)]
    ref = [(jax.tree_util.keystr(path), x) for path, x in
           jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == [n for n, _ in ref]
    assert "['shared_attn']['wo']" in names
    for (name, j), t in zip(ref, adamw.tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert tp["shared_attn"]["wq"].shape == (256, 256)
    assert m.count_params() == sum(t.numel() for t in adamw.tree_leaves(tp))


def test_shared_block_output_scale_is_a_one_layer_models(fp32_pair):
    """``shared_attn/wo`` draws at 0.02 / sqrt(2), as the reference's
    ``_attn_leaves(replace(cfg, num_layers=1))``; the Mamba2 layers'
    ``out_proj`` at 0.02 / sqrt(2 L)."""
    _, jp, m, _ = fp32_pair
    schema = param_schema(m.cfg)
    assert schema["shared_attn"]["wo"].init == ("normal", 0.02 / 2 ** 0.5)
    assert schema["shared_attn"]["wq"].init == ("normal", 0.02)
    assert schema["layers"]["out_proj"].init == (
        "normal", 0.02 / (2 * LAYERS) ** 0.5)
    p = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    for got in (p["shared_attn"]["wo"].std().item(),
                float(np.std(np.asarray(jp["shared_attn"]["wo"])))):
        assert abs(got - 0.02 / 2 ** 0.5) < 5e-4
    assert torch.all(p["shared_attn"]["attn_norm"] == 1)


# ------------------------------------------------------------ serving ---

@pytest.mark.parametrize("s,cache_len", [(100, 128), (80, 96)])
def test_prefill_then_decode_matches_reference(fp32_pair, s, cache_len):
    """Logits and every cache leaf: the Mamba2 states of the five layers,
    the three calls' rings (the window of 64 wraps them)."""
    jm, jp, m, tp = fp32_pair
    assert m.cache_window(cache_len) == jm.cache_window(cache_len) == 64
    toks = _tokens(m.cfg.vocab_size, 2, s, seed=s)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             cache_len=cache_len))(
        jp, jnp.asarray(toks))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       cache_len=cache_len)
    assert tl.dtype == torch.float32 and tl.shape == (2, m.cfg.vocab_size)
    _close_leaf("logits", jl, tl, FP32_TOL)
    assert tc["k"].shape[0] == 3 and tc["ssm"].shape[0] == LAYERS
    _assert_caches(jc, tc, FP32_TOL)
    decode = jax.jit(jm.decode_step)
    pos = s
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = decode(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        pos += 1
        _close_leaf(f"logits @ {pos}", jl, tl, FP32_TOL)
        _assert_caches(jc, tc, FP32_TOL)


def test_bf16_prefill_and_decode_match_reference(jax_rules):
    jm, jp, m, tp = _pair(jax_rules, "bfloat16")
    tp = m.serving_params(tp)
    assert tp["shared_attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["A_log"].dtype == torch.float32
    toks = _tokens(m.cfg.vocab_size, 2, 90, seed=5)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             cache_len=128))(
        jp, jnp.asarray(toks))
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=128)
    _close_rel(jl, tl, BF16_TOL)
    _assert_caches(jc, tc, BF16_TOL, rel_l2=True)
    decode = jax.jit(jm.decode_step)
    for pos in range(90, 93):
        nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        jl, jc = decode(jp, jnp.asarray(nxt), jc, jnp.int32(pos))
        tl, tc = m.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        _close_rel(jl, tl, BF16_TOL)


def test_prefill_agrees_with_prefill_plus_decode(fp32_pair):
    """prefill(S) last logits == prefill(S-1) then decode_step(token S-1),
    past the window."""
    _, _, m, tp = fp32_pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, 2, 90, seed=3))
    full, _ = m.prefill(tp, {"tokens": toks}, cache_len=128)
    _, cache = m.prefill(tp, {"tokens": toks[:, :-1]}, cache_len=128)
    step, _ = m.decode_step(tp, toks[:, -1:], cache, 89)
    torch.testing.assert_close(step, full, atol=FP32_TOL, rtol=FP32_TOL)


def test_fp32_masters_serve_like_cast_parameters(jax_rules):
    """Every use casts: prefill and decode_step over fp32 masters are
    bit-equal to the same calls over ``serving_params`` of them."""
    _, _, m, tp = _pair(jax_rules, "bfloat16")
    cast = m.serving_params(tp)
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, 2, 71, seed=4))
    with torch.no_grad():
        a, ca = m.prefill(tp, {"tokens": toks[:, :70]}, cache_len=96)
        b, cb = m.prefill(cast, {"tokens": toks[:, :70]}, cache_len=96)
        assert torch.equal(a, b)
        a, ca = m.decode_step(tp, toks[:, 70:], ca, 70)
        b, cb = m.decode_step(cast, toks[:, 70:], cb, 70)
    assert torch.equal(a, b)
    for name in ca:
        assert torch.equal(ca[name], cb[name]), name


# ----------------------------------------------------------- training ---

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
    names = [name for name, _, _ in _leaves(jgrads, grads)]
    assert "shared_attn/wq" in names and "shared_attn/attn_norm" in names
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
    assert tp["shared_attn"]["wo"].dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)
    for name, j, t in _leaves(jgrads, grads):
        _close_rel(j, t, BF16_TOL)


def test_remat_gives_the_same_gradients(fp32_pair):
    """Bit for bit, under deterministic algorithms: past ~100 tokens the
    CPU's gather backward adds the embedding's rows in parallel, in an
    order that changes from call to call, with or without remat."""
    _, _, m, tp = fp32_pair
    _, tb = _batch(m.cfg.vocab_size, step=2)
    assert m.remat
    plain = Model(m.cfg, device="cpu", remat=False)
    torch.use_deterministic_algorithms(True)
    try:
        loss, _, grads = _port_grads(m, tp, tb)
        loss2, _, grads2 = _port_grads(plain, tp, tb)
    finally:
        torch.use_deterministic_algorithms(False)
    assert loss.item() == loss2.item()
    for t, t2 in zip(adamw.tree_leaves(grads), adamw.tree_leaves(grads2)):
        assert torch.equal(t, t2)


def test_shared_block_gradient_sums_its_calls(fp32_pair):
    """The step's leaf views add every call's gradient into the one
    ``shared_attn`` buffer: the same as autograd through the whole tree's
    leaves, and the sum of what each call alone contributes."""
    _, _, m, tp = fp32_pair
    _, tb = _batch(m.cfg.vocab_size, step=3)
    _, _, grads = _port_grads(m, tp, tb)
    leaves = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
    m.train_loss(leaves, tb)[0].backward()
    for part in ("layers", "shared_attn"):
        for name, t in leaves[part].items():
            torch.testing.assert_close(grads[part][name], t.grad, rtol=1e-6,
                                       atol=1e-7)
            assert torch.count_nonzero(t.grad) > 0, (part, name)
    # each call apart: a copy of the block per call, the others detached
    per_call = []
    for call in range(3):
        copy = {n: t.detach().clone().requires_grad_()
                for n, t in tp["shared_attn"].items()}
        frozen = {n: t.detach() for n, t in tp["shared_attn"].items()}
        sched = m._schedule
        m._schedule = lambda p, c=call: [
            (k, copy if k == "attn" and i == c else
             (frozen if k == "attn" else q), i) for k, q, i in sched(p)]
        try:
            m.train_loss(tp, tb)[0].backward()
        finally:
            del m._schedule
        per_call.append(copy["wq"].grad)
    torch.testing.assert_close(sum(per_call), grads["shared_attn"]["wq"],
                               rtol=1e-5, atol=1e-7)
    assert all(torch.count_nonzero(g) > 0 for g in per_call)


def test_train_step_matches_reference(fp32_pair):
    """Three steps of make_train_step: the metrics, mu, nu and step to
    2e-4, the shared block's among them. The parameters by their move, as
    Adam makes it: it divides each element's mu by its sqrt(nu), which
    amplifies the fp32 noise of an element whose gradient is small or
    changes sign between steps (tests/test_torch_train.py). So each leaf's
    change over the steps to 1e-2 by its relative L2 error (measured <=
    1.3e-3, the embedding's; the others <= 1.6e-4), and each element to
    2e-4 of the leaf's largest entry or a tenth of the largest move Adam
    can make (the sum of the learning rates; measured <= 4%), or, where
    the 2e-4 gate on mu cannot tell the element's mu from zero (a few of
    the embedding's, |mu| ~ 1e-7 of the leaf's largest), twice it."""
    jm, jp, m, tp = fp32_pair
    j0, t0 = jp, adamw.tree_map(torch.clone, tp)
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
    for part, jt, tt in (("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        for name, j, t in _leaves(jt, tt):
            _close_leaf(f"{part}/{name}", j, t, FP32_TOL)
    for (name, j, t), (_, j_0, t_0), (_, mu, _) in zip(
            _leaves(jp, tp), _leaves(j0, t0), _leaves(js["mu"], ts["mu"])):
        j, j_0, mu = np.asarray(j), np.asarray(j_0), np.abs(np.asarray(mu))
        assert not torch.equal(t, t_0), name
        _close_rel(j - j_0, t - t_0, 1e-2)
        zero = mu <= FP32_TOL * mu.max()
        atol = np.maximum(FP32_TOL * np.abs(j).max(),
                          np.where(zero, 2 * moved, 0.1 * moved))
        err = np.abs(t.numpy() - j)
        assert np.all(err <= atol + FP32_TOL * np.abs(j)), (name, err.max())
    assert ts["step"].item() == int(js["step"]) == 3


def test_train_loop_history_matches_reference(jax_rules):
    jm, jp, m, tp = _pair(jax_rules, "float32")
    _, _, jhist = jtrain_loop(jm, batch=B, seq_len=S, steps=3, log_every=1,
                              log_fn=lambda _: None,
                              params=jax.tree.map(jnp.copy, jp))
    _, _, hist = train_loop(m, batch=B, seq_len=S, steps=3, log_every=1,
                            log_fn=lambda _: None, params=tp)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2]
    for h, jh in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=FP32_TOL)
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"],
                                   rtol=FP32_TOL)


# ---------------------------------------------------------- launchers ---

def test_train_cli_loss_falls_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                    "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and "zamba2-1.2b-tiny" in done[0]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert last < first


def test_serve_cli_boots_twice_with_the_same_greedy_tokens(tmp_path, capsys):
    """Cold, then warm through the runtime from the same workdir: the
    checkpoint seeded once, the same greedy tokens both times."""
    args = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
            "--new-tokens", "4", "--batch", "2", "--cache-len", "96",
            "--workdir", str(tmp_path)]
    runs = []
    for _ in range(2):
        serve_cli.main(args)
        runs.append(capsys.readouterr().out)
    assert "seeded checkpoint step 0" in runs[0] and "(cold)" in runs[0]
    assert "seeded" not in runs[1] and "(warm)" in runs[1]
    assert all("zamba2-1.2b-tiny" in out for out in runs)
    ends = [json.loads(next(line for line in out.splitlines()
                            if line.startswith("boot-end: "))[10:])
            for out in runs]
    tokens = [end["greedy_tokens"] for end in ends]
    assert tokens[0] == tokens[1] and len(tokens[0]) == 2
    assert all(len(t) == 4 for t in tokens[0])
    assert "first token" in runs[1]
