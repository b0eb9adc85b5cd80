"""The plain reference at small sizes on the CPU: its module found by the
configuration's arch_type, its chunked SSD scan against the step-by-step
recurrence, and its loss and gradients against the program run in float32
(the program's plain CPU versions), from the same weights and rows."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import generator  # noqa: E402
from perfbench.harness import RunError  # noqa: E402
from perfbench.reference import architecture  # noqa: E402
from perfbench.reference import ssm as ref  # noqa: E402
from perfbench.reference.common import named_leaves, unstack  # noqa: E402
from perfbench.reference.train import grads_of  # noqa: E402


def recurrence(x, dt, A, B, C, D):
    r, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    state = torch.zeros(r, h, p, n, dtype=x.dtype)
    ys = []
    for t in range(s):
        Bt = B[:, t].repeat_interleave(h // g, dim=1)     # [r, h, n]
        Ct = C[:, t].repeat_interleave(h // g, dim=1)
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        state = state * decay + (dt[:, t, :, None] * x[:, t])[..., None] \
            * Bt[:, :, None, :]
        ys.append((state * Ct[:, :, None, :]).sum(-1) + D[:, None] * x[:, t])
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("s,chunk,g", [(16, 4, 1), (19, 8, 2), (8, 8, 1)])
def test_ssd_scan_is_the_recurrence(s, chunk, g):
    gen = torch.Generator().manual_seed(s)
    r, h, p, n = 2, 4, 3, 5
    f64 = dict(dtype=torch.float64, generator=gen)
    x = torch.randn(r, s, h, p, **f64)
    dt = torch.rand(r, s, h, **f64) * 0.5
    A = -torch.rand(h, **f64) * 3
    B, C = torch.randn(r, s, g, n, **f64), torch.randn(r, s, g, n, **f64)
    D = torch.randn(h, **f64)
    got = ref.ssd_scan(x, dt, A, B, C, D, chunk)
    assert torch.allclose(got, recurrence(x, dt, A, B, C, D), atol=1e-10)


SSM = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=32,
           ngroups=1)
CFGS = {
    "ssm": dict(name="mamba2-370m", source="test", arch_type="ssm", num_layers=2,
                d_model=64, vocab_size=256, num_heads=0, num_kv_heads=0,
                head_dim=0, d_ff=0, rope_theta=1e6, norm_eps=1e-5,
                sliding_window=0, shared_attention_every=0, ssm=SSM,
                dtype="float32", param_dtype="float32"),
}


def test_only_the_ssm_architecture_is_modelled():
    """The configuration's arch_type finds its module by file; one with no
    file is refused, naming the path looked for; ssm.py's reference
    models its own architecture alone."""
    assert architecture(CFGS["ssm"]) is ref
    with pytest.raises(RunError, match="perfbench/reference/unmodelled.py"):
        architecture(dict(CFGS["ssm"], arch_type="unmodelled"))
    with pytest.raises(ValueError, match="hybrid"):
        ref.Reference(dict(CFGS["ssm"], arch_type="hybrid"))


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_loss_and_gradients_are_the_programs_in_float32(arch):
    from perfbench.harness import program_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import loss_and_grads
    cfg = CFGS[arch]
    params = generator.weights(cfg, 11, "cpu")
    tokens, labels = generator.stream_for(cfg, {}, 11).batch(0, 3, 80, "cpu")
    model = Model(program_config(cfg), device="cpu", remat=False)
    grads = tree_map(torch.zeros_like, params)
    loss, _ = loss_and_grads(model, params, {"tokens": tokens.contiguous(),
                                             "labels": labels.contiguous()},
                             grads)
    mine = unstack(params)
    ref_loss, ref_grads = grads_of(ref.Reference(cfg), mine, tokens, labels,
                                   rows=2)
    assert ref_loss == pytest.approx(float(loss), rel=1e-5)
    names = [n for n, _ in named_leaves(mine)]
    theirs = dict(named_leaves(unstack(grads)))
    for name, g in zip(names, ref_grads):
        scale = max(float(theirs[name].abs().max()), 1e-6)
        assert float((g - theirs[name]).abs().max()) <= 2e-4 * scale, name
