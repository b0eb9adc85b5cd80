"""The frontend families' training path against the JAX package's: tiny
qwen2-vl-72b (from stand-in embeddings with vision-grid M-RoPE
positions), tiny musicgen-large (from embeddings) and musicgen with an
MoE block (4 experts, top 2, capacity factor 8: nothing dropped):
``train_loss`` and every gradient leaf, with and without remat, in fp32
and bf16, and one AdamW step. The ``embed`` leaf is unused when the batch
holds embeddings: its gradient is exactly zero on both sides and AdamW
only decays it.

The reference runs on an Auto-axis (1, 1) mesh under ``jax.jit``.
Tolerances: fp32 to 2e-4 of each leaf's largest entry; bf16 to 4e-2 by
each leaf's relative L2 error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticStream as JStream
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_frontend import (AUDIO, CASES, VLM, inputs,  # noqa: F401
                                 jax_rules, pairs)
from test_torch_train import _close_leaf, _leaves

FP32_TOL = 2e-4
BF16_TOL = 4e-2
B, S = 2, 48


def _batch(cfg, step: int = 0):
    """(reference batch, port batch): embeddings (and M-RoPE positions)
    from a numpy seed, labels from the synthetic stream."""
    jb, tb = inputs(cfg, B, S, seed=10 + step)
    labels = JStream(cfg.vocab_size, 0).batch(step, B, S)[:, 1:]
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels.copy())
    return jb, tb


def _port_grads(m, tp, batch):
    grads = adamw.tree_map(torch.zeros_like, tp)
    loss, metrics = loss_and_grads(m, tp, batch, grads)
    return loss, metrics, grads


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_match_reference_fp32(pairs, case, remat):
    jm, jp, m, tp = pairs(case, masters=True)
    m = Model(m.cfg, device="cpu", remat=remat)
    jb, tb = _batch(m.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    loss, met, grads = _port_grads(m, tp, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=FP32_TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=FP32_TOL, atol=1e-7, err_msg=key)
    for name, j, t in _leaves(jgrads, grads):
        _close_leaf(name, j, t, FP32_TOL)
    assert not np.asarray(jgrads["embed"]).any()
    assert torch.count_nonzero(grads["embed"]) == 0


@pytest.mark.parametrize("case", [VLM, AUDIO])
def test_train_loss_and_grads_match_reference_bf16(pairs, case):
    """bf16 compute over fp32 masters on both sides: the embeddings are
    cast to bf16 before the first layer."""
    jm, jp, m, tp = pairs(case, "bfloat16", masters=True)
    jb, tb = _batch(m.cfg, step=1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    loss, _, grads = _port_grads(m, tp, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)
    for name, j, t in _leaves(jgrads, grads):
        if name == "embed":
            assert torch.count_nonzero(t) == 0 and not np.asarray(j).any()
            continue
        j = np.asarray(j, np.float32)
        err = np.linalg.norm(t.numpy() - j) / max(np.linalg.norm(j), 1e-30)
        assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("case", [VLM, AUDIO])
def test_remat_gives_the_same_gradients(pairs, case):
    """Remat recomputes each layer with the same M-RoPE positions: the
    loss and every gradient leaf bit-equal to those without remat."""
    _, _, m, tp = pairs(case, masters=True)
    _, tb = _batch(m.cfg, step=2)
    assert m.remat
    loss, _, grads = _port_grads(m, tp, tb)
    plain = Model(m.cfg, device="cpu", remat=False)
    loss2, _, grads2 = _port_grads(plain, tp, tb)
    assert loss.item() == loss2.item()
    for t, t2 in zip(adamw.tree_leaves(grads), adamw.tree_leaves(grads2)):
        assert torch.equal(t, t2)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(pairs, case):
    """One AdamW step from embeddings: the metrics, params, mu and nu. The
    unused ``embed`` leaf keeps zero moments and is only decayed, p (1 -
    lr wd), on both sides. The parameters are also allowed 1% of the
    largest move Adam can make (lr), as in tests/test_torch_train.py."""
    jm, jp, m, tp = pairs(case, masters=True)
    tp = adamw.tree_map(torch.clone, tp)
    embed0 = tp["embed"].clone()
    cfg = adamw.AdamWConfig()
    jb, tb = _batch(m.cfg, step=3)
    jp, js, jmet = jax.jit(jmake_train_step(jm, jadamw.AdamWConfig()))(
        jp, jadamw.adamw_init(jp), jb)
    tp, ts, tmet = make_train_step(m, cfg)(tp, adamw.adamw_init(tp), tb)
    assert set(tmet) == set(jmet)
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=FP32_TOL, atol=1e-7, err_msg=key)
    for part, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        for name, j, t in _leaves(jt, tt):
            _close_leaf(f"{part}/{name}", j, t, FP32_TOL,
                        atol=1e-2 * cfg.lr if part == "params" else 0.0)
    assert torch.count_nonzero(ts["mu"]["embed"]) == 0
    assert torch.count_nonzero(ts["nu"]["embed"]) == 0
    torch.testing.assert_close(tp["embed"],
                               embed0 * (1 - cfg.lr * cfg.weight_decay),
                               rtol=1e-6, atol=0)
    assert not torch.equal(tp["embed"], embed0)


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_train_cli_loss_falls_on_cpu(capsys, arch):
    """The launcher trains a frontend family from tokens, as the
    reference's launcher does (plain RoPE: no mrope_pos)."""
    train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "12",
                    "--batch", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and f"{arch}-tiny" in done[0]
    first, last = (float(x) for x in done[0].split()[2:5:2])
    assert last < first


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_serve_cli_on_cpu(capsys, arch):
    """The serving launcher answers token prompts of a frontend family."""
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                    "--new-tokens", "4", "--batch", "2", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on CPU" in out
    assert f"{arch}-tiny" in out

