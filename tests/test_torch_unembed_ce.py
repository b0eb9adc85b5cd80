"""The vocab-chunked unembedding and cross-entropy (``kernels/unembed_ce.py``)
against the composition it replaced: the fp32 upcasts' product, then
``logsumexp`` and ``gather`` over the whole logits, and autograd through
them, whose gradients were rounded to bf16 once by the upcasts' backward.
The tests marked ``gpu`` hold its kernels to the plain version on the card
and skip without one; this file imports no JAX, so it runs as it is on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_unembed_ce.py

Tolerances. The loss differs from the composition's by fp32 rounding only
(a running max and sum over chunks against one log-sum-exp): 1e-6
relative. dh and dW are fp32 sums in another order, rounded once to the
operands' dtype, so in bf16 an element may land one bf16 step (2^-8
relative) away where the fp32 values straddle a rounding boundary: held
by the worst row's relative L2 error (``row_rel_err``) to 2^-8, one bf16
rounding, and in fp32 to 1e-5. Through a whole tiny model the same
rounding reaches every layer's gradient, 1e-2 by the worst row in bf16.
"""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import unembed_ce
from repro_torch.kernels.ops import unembed_ce_chunked, unembed_cross_entropy
from repro_torch.kernels.ref import (ce_fold_reference, ce_grad_reference,
                                     row_rel_err, split_planes)
from repro_torch.kernels.unembed_ce import (
    CHUNK_BYTES, ce_fold_kernel, ce_grad_kernel, unembed_ce_bwd_op,
    unembed_ce_fwd_op, unembed_ce_plain, unembed_ce_workspace_floats,
    vocab_chunk)
from repro_torch.launch import dryrun
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train.step import loss_and_grads

BF16_GRAD_ROW = 2.0 ** -8
FP32_GRAD_ROW = 1e-5
LOSS_RTOL = 1e-6
MODEL_GRAD_ROW = 1e-2


def _workspace(h, table, chunk, backward):
    return torch.empty((unembed_ce_workspace_floats(
        h.shape[0], h.shape[1], table.shape[1], h.dtype, chunk,
        backward=backward),), device=h.device)


def _composition(h, table, labels):
    """What the one-device training loss was: fp32 logits of the whole
    vocabulary, their log-sum-exp and the label's logit."""
    logits = h.float() @ table.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def _inputs(rows, d, vocab, dtype, tied, chunk, seed=0):
    """h [rows, d], table [d, V] (tied: a transposed view of a [V, d]
    embedding), labels with ids on each chunk's first and last column, on
    the last (padded) ids and on column 0, the rest random."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((rows, d), generator=gen).to(dtype)
    if tied:
        table = (0.5 * torch.randn((vocab, d), generator=gen)).to(dtype).t()
    else:
        table = (0.5 * torch.randn((d, vocab), generator=gen)).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=gen,
                           dtype=torch.int32)
    edges = sorted({c for v0 in range(0, vocab, chunk)
                    for c in (v0, min(v0 + chunk, vocab) - 1)}
                   | {vocab - 1, vocab - 2, vocab - 3})
    labels[:len(edges)] = torch.tensor(edges[:rows], dtype=torch.int32)
    return h, table, labels


def _grads_of_composition(h, table, labels, gbar):
    hf = h.detach().clone().requires_grad_()
    tf = table.detach().clone().requires_grad_()
    loss = _composition(hf, tf, labels)
    (loss * gbar).backward()
    return loss.detach(), hf.grad, tf.grad


# (rows, d, vocab, chunk): several chunks with a ragged last one, a single
# chunk, chunks of one aligned width with an odd last width
SHAPES = [(48, 32, 1000, 256), (40, 24, 300, 300), (33, 16, 517, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("gbar", [1.0, -0.37])
@pytest.mark.parametrize("rows,d,vocab,chunk", SHAPES)
def test_op_matches_the_composition(dtype, tied, gbar, rows, d, vocab,
                                    chunk):
    """Loss, dh and dW (rounded to the operands' dtype once, as the
    upcasts' backward rounded them) against the composition's, through
    the operator's own autograd, for the loss's gradient ``gbar``."""
    h, table, labels = _inputs(rows, d, vocab, dtype, tied, chunk)
    ref_loss, ref_dh, ref_dt = _grads_of_composition(h, table, labels, gbar)
    hv = h.detach().clone().requires_grad_()
    tv = table.detach().clone().requires_grad_()
    loss = unembed_ce_chunked(hv, tv, labels, chunk)
    (loss * gbar).backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - ref_loss.item()) <= LOSS_RTOL * ref_loss.item()
    assert hv.grad.dtype == dtype and tv.grad.dtype == dtype
    assert tv.grad.stride() == table.stride()
    tol = BF16_GRAD_ROW if dtype == torch.bfloat16 else FP32_GRAD_ROW
    assert row_rel_err(hv.grad, ref_dh.to(dtype)) <= tol
    assert row_rel_err(tv.grad.t(), ref_dt.to(dtype).t()) <= tol


def test_loss_is_the_same_for_every_chunk_width():
    """The chunking moves the loss by fp32 rounding only, and a label on
    any column is picked from its own chunk."""
    h, table, labels = _inputs(64, 32, 640, torch.bfloat16, False, 128)
    losses = [unembed_ce_chunked(h, table, labels, c).item()
              for c in (128, 200, 256, 640, 4096)]
    assert max(losses) - min(losses) <= LOSS_RTOL * losses[0]


def test_a_label_outside_the_vocabulary_gives_nan():
    h, table, labels = _inputs(8, 16, 300, torch.float32, False, 128)
    labels[3] = 300
    assert math.isnan(unembed_ce_chunked(h, table, labels, 128).item())


def test_split_planes_sum_to_the_fp32_value_bit_for_bit():
    """hi + mid + lo == g exactly, from 2^-100 to 2^100 and both signs,
    with every fp32 significand pattern the draw reaches (sums in fp64,
    where three bf16 values add without rounding)."""
    gen = torch.Generator().manual_seed(1)
    exps = torch.arange(-100, 101, dtype=torch.float64)
    mant = 1 + torch.rand((exps.numel(), 512), generator=gen,
                          dtype=torch.float64)
    sign = torch.where(torch.rand(mant.shape, generator=gen) < 0.5, -1.0,
                       1.0)
    g = (sign * mant * torch.exp2(exps)[:, None]).float()
    planes = split_planes(g)
    assert planes.dtype == torch.bfloat16 and planes.shape == (201, 3, 512)
    total = planes.double().sum(dim=1)
    assert torch.equal(total, g.double())
    # a plain two-plane split would not be exact
    assert not torch.equal(planes[:, :2].double().sum(dim=1), g.double())


def test_the_gradient_pass_writes_planes_of_its_fp32_gradient():
    h, table, labels = _inputs(16, 8, 256, torch.bfloat16, False, 256)
    logits = h.float() @ table.float()
    lse = torch.logsumexp(logits, dim=-1)
    dce = torch.tensor(0.5)
    planes = torch.empty((16, 3, 256), dtype=torch.bfloat16)
    assert ce_grad_reference(logits, labels, 0, lse, dce,
                             planes=planes) is planes
    g = logits.clone()
    assert ce_grad_reference(g, labels, 0, lse, dce) is g   # in place
    assert torch.equal(planes.double().sum(dim=1), g.double())
    soft = torch.softmax(logits, dim=-1)
    soft[torch.arange(16), labels.long()] -= 1
    torch.testing.assert_close(g, soft * 0.5 / 16, rtol=1e-5, atol=1e-9)


def test_the_fold_over_chunks_is_the_log_sum_exp():
    h, table, labels = _inputs(16, 8, 700, torch.float32, False, 256)
    logits = h @ table
    state = torch.empty((3, 16))
    lse = torch.empty(16)
    for v0 in range(0, 700, 256):
        ce_fold_reference(logits[:, v0:v0 + 256], labels, v0, state, lse,
                          first=v0 == 0, last=v0 + 256 >= 700)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-6,
                               atol=0)
    assert torch.equal(state[2], logits.gather(1, labels.long()[:, None])
                       [:, 0])


def _chunk_bytes(rows, d, chunk, dtype):
    """A chunk's buffers, counted here from what the loop holds: its fp32
    logits and dW chunk; in bf16 its planes and the tripled table chunk."""
    if dtype == torch.bfloat16:
        return chunk * (4 * rows + 6 * rows + 6 * d + 4 * d)
    return chunk * (4 * rows + 4 * d)


@pytest.mark.parametrize("rows,d,vocab,dtype,want,n", [
    # mamba2-370m's training cell and chip_smoke's batch of 8
    (16 * 2048, 1024, 50432, torch.bfloat16, 5632, 9),
    (8 * 2048, 1024, 50432, torch.bfloat16, 10112, 5),
    # qwen2-vl-72b's and qwen2.5-3b's training shapes: wide rows, few of them
    (2 * 2048, 8192, 152064, torch.bfloat16, 16896, 9),
    (2 * 2048, 2048, 151936, torch.bfloat16, 30464, 5),
    (2 * 2048, 2048, 151936, torch.float32, 76032, 2),
])
def test_vocab_chunk_comes_from_the_shapes(rows, d, vocab, dtype, want, n):
    """The fewest chunks whose buffers each fit ``CHUNK_BYTES``, of one
    aligned width but the last, which is no sliver; and the workspace
    is those buffers plus the ones of the rows alone, whatever d."""
    vc = vocab_chunk(rows, d, vocab, dtype)
    assert vc == want and vc % 128 == 0 and -(-vocab // vc) == n
    assert _chunk_bytes(rows, d, vc, dtype) <= CHUNK_BYTES
    assert vocab - (n - 1) * vc > vc // 2
    fixed = rows * d * (14 if dtype == torch.bfloat16 else 8)
    ws = 4 * unembed_ce_workspace_floats(rows, d, vocab, dtype, vc,
                                         backward=True)
    assert _chunk_bytes(rows, d, vc, dtype) + fixed <= ws
    assert ws <= CHUNK_BYTES + fixed + 8 * 256


def test_vocab_chunk_at_its_edges():
    assert vocab_chunk(4, 16, 512, torch.bfloat16) == 512   # one chunk
    assert vocab_chunk(10 ** 7, 16, 151936, torch.bfloat16) == 128


def test_flops_are_the_functions_least_work():
    """2 T d V forward, 4 T d V backward, whatever the chunking."""
    h, table, labels = _inputs(24, 16, 300, torch.bfloat16, False, 128)
    h.requires_grad_()
    with FlopCounterMode(display=False) as count:
        unembed_ce_chunked(h, table, labels, 128).backward()
    assert count.get_total_flops() == 6 * 24 * 16 * 300


def test_meta_tensors_take_the_fake_implementations():
    meta = dict(device="meta")
    h = torch.empty((32, 16), dtype=torch.bfloat16, **meta)
    table = torch.empty((300, 16), dtype=torch.bfloat16, **meta).t()
    labels = torch.empty((32,), dtype=torch.int32, **meta)
    ce, lse = unembed_ce_fwd_op(h, table, labels, _workspace(h, table, 128,
                                                             False), 128)
    assert ce.shape == () and lse.shape == (32,)
    assert ce.dtype == lse.dtype == torch.float32
    dh, dt = unembed_ce_bwd_op(h, table, labels, lse, ce,
                               _workspace(h, table, 128, True), 128)
    assert dh.shape == h.shape and dt.shape == table.shape
    assert dt.stride() == table.stride()


def test_the_operator_refuses_what_it_cannot_take():
    h, table, labels = _inputs(8, 16, 300, torch.bfloat16, False, 128)
    ws = _workspace(h, table, 128, True)
    with pytest.raises(TypeError, match="one of"):
        unembed_ce_fwd_op(h, table.float(), labels, ws, 128)
    with pytest.raises(TypeError, match="one of"):
        unembed_ce_fwd_op(h.half(), table.half(), labels, ws, 128)
    with pytest.raises(ValueError, match="labels"):
        unembed_ce_fwd_op(h, table, labels[:4], ws, 128)
    with pytest.raises(ValueError, match="table"):
        unembed_ce_fwd_op(h, table[:8], labels, ws, 128)
    with pytest.raises(ValueError, match="workspace"):
        unembed_ce_fwd_op(h, table, labels, ws[:100], 128)
    lse = torch.zeros(8)
    with pytest.raises(ValueError, match="workspace"):
        unembed_ce_bwd_op(h, table, labels, lse, torch.ones(()),
                          _workspace(h, table, 128, False), 128)


def test_the_kernels_refuse_cpu_tensors():
    logits = torch.zeros((4, 128))
    labels = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ce_fold_kernel(logits, labels, 0, torch.zeros((3, 4)),
                       torch.zeros(4), first=True, last=True)
    with pytest.raises(ValueError, match="CUDA"):
        ce_grad_kernel(logits, labels, 0, torch.zeros(4), torch.ones(()),
                       planes=torch.zeros((4, 3, 128), dtype=torch.bfloat16))


@pytest.mark.parametrize("arch,tied,dtype", [
    ("mamba2-370m", False, "bfloat16"),
    ("qwen2.5-3b", False, "bfloat16"),
    ("qwen2.5-3b", True, "bfloat16"),
    ("qwen2.5-3b", True, "float32"),
])
def test_train_loss_is_the_compositions(monkeypatch, arch, tied, dtype):
    """``Model.train_loss`` on ``PlainOps`` through the operator, its
    vocabulary in several chunks, against the same model with the
    composition in its place: the same loss and gradients (fp32 masters,
    the compute dtype ``dtype``)."""
    cfg = reduced(get_config(arch), tie_embeddings=tied, dtype=dtype)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    b, s = 2, 24
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    # ~200 columns a chunk in bf16: several chunks over the tiny vocabulary
    monkeypatch.setattr(unembed_ce, "CHUNK_BYTES",
                        200 * 10 * (b * s + cfg.d_model))
    assert vocab_chunk(b * s, cfg.d_model, cfg.vocab_size,
                       getattr(torch, dtype)) < cfg.vocab_size

    def run():
        grads = tree_map(torch.zeros_like, params)
        loss, _ = loss_and_grads(m, params, batch, grads)
        return loss, grads

    loss, grads = run()
    monkeypatch.setattr(m.ops, "unembed_cross_entropy", _composition)
    ref_loss, ref_grads = run()
    assert abs(loss.item() - ref_loss.item()) <= LOSS_RTOL * ref_loss.item()
    tol = MODEL_GRAD_ROW if dtype == "bfloat16" else FP32_GRAD_ROW
    for g, r in zip(tree_leaves(grads), tree_leaves(ref_grads)):
        assert row_rel_err(g.reshape(-1, g.shape[-1]) if g.dim() else g[None],
                           r.reshape(-1, r.shape[-1]) if r.dim() else r[None],
                           floor=1e-2) <= tol


def test_the_entry_point_flattens_the_batch():
    h, table, labels = _inputs(48, 32, 1000, torch.bfloat16, False, 256)
    flat = unembed_ce_chunked(h, table, labels,
                      vocab_chunk(48, 32, 1000, torch.bfloat16))
    shaped = unembed_cross_entropy(h.reshape(4, 12, 32), table,
                                   labels.reshape(4, 12))
    assert torch.equal(flat, shaped)


def test_the_loops_workspaces_are_counted():
    """The loss's two operators take their workspaces as arguments, so a
    training step's count sees them on the meta device (the dry run): in
    each operator's bytes and in the step's peak."""
    cfg = reduced(get_config("mamba2-370m"))
    b, s = 2, 64
    rec = dryrun.run_one("mamba2-370m", cfg=cfg,
                         shape=ShapeConfig("t", s, b, "train"), verbose=False)
    rows, d, vocab = b * s, cfg.d_model, cfg.vocab_size
    dtype = getattr(torch, cfg.dtype)
    vc = vocab_chunk(rows, d, vocab, dtype)
    by_op = rec["cost_analytic_global"]["by_op"]
    for name, backward in (("fwd", False), ("bwd", True)):
        ws = 4 * unembed_ce_workspace_floats(rows, d, vocab, dtype, vc,
                                             backward=backward)
        op = by_op[f"repro_torch.unembed_ce_{name}"]
        assert op["calls"] == 1 and op["bytes"] > ws
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] + ws


# ----- on the card -----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the operator's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _on_card(rows, d, vocab, dtype, tied, chunk, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    shape = (vocab, d) if tied else (d, vocab)
    table = (0.05 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    table = table.t() if tied else table
    labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev,
                           dtype=torch.int32)
    return h, table, labels


def _plain(h, table, labels, chunk, gbar):
    """The operator's loop with the kernels' plain versions, on the card."""
    dce = torch.tensor(gbar, device=h.device)
    return unembed_ce_plain(h, table, labels, dce, chunk)


def _op_and_grads(h, table, labels, chunk, gbar):
    hv = h.detach().clone().requires_grad_()
    tv = table.detach().clone().requires_grad_()
    loss = unembed_ce_chunked(hv, tv, labels, chunk)
    (loss * gbar).backward()
    return loss.detach(), hv.grad, tv.grad


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,vocab,chunk,dtype,tied", [
    (16 * 2048, 1024, 50432, 5632, torch.bfloat16, False),
    (1000, 256, 1001, 128, torch.bfloat16, True),
    (1000, 256, 1001, 384, torch.float32, False),
])
def test_kernels_match_plain_on_card(cuda, rows, d, vocab, chunk, dtype,
                                     tied):
    """The first case is mamba2-370m's training shape (16 x 2048 over
    1024 x 50,432); the others the kernels' 4-byte paths (odd widths),
    a tied table and fp32 operands."""
    h, table, labels = _on_card(rows, d, vocab, dtype, tied, chunk, cuda)
    chunks = -(-vocab // chunk)
    f0, g0 = ce_fold_kernel.launches, ce_grad_kernel.launches
    loss, dh, dt = _op_and_grads(h, table, labels, chunk, 0.7)
    torch.cuda.synchronize()
    assert ce_fold_kernel.launches - f0 == chunks
    assert ce_grad_kernel.launches - g0 == chunks
    ref_loss, ref_dh, ref_dt = _plain(h, table, labels, chunk, 0.7)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
    tol = 1e-2 if dtype == torch.bfloat16 else FP32_GRAD_ROW
    assert row_rel_err(dh, ref_dh, floor=1e-2) <= tol
    assert row_rel_err(dt.t(), ref_dt.t(), floor=1e-2) <= tol
    assert ce_fold_kernel.launches - f0 == chunks   # the plain ran none


@pytest.mark.gpu
def test_kernel_planes_sum_to_its_fp32_gradient_on_card(cuda):
    h, table, labels = _on_card(4096, 256, 2048, torch.bfloat16, False,
                                2048, cuda)
    logits = torch.mm(h, table, out_dtype=torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    dce = torch.tensor(1.3, device=cuda)
    planes = torch.empty((4096, 3, 2048), dtype=torch.bfloat16, device=cuda)
    assert ce_grad_kernel(logits, labels, 0, lse, dce,
                          planes=planes) is planes
    g = logits.clone()
    assert ce_grad_kernel(g, labels, 0, lse, dce) is g   # in place
    assert torch.equal(planes.double().sum(dim=1), g.double())
    ref = ce_grad_reference(logits, labels, 0, lse, dce)
    assert row_rel_err(g, ref) <= 1e-5


@pytest.mark.gpu
def test_memory_is_one_chunks_not_the_logits_on_card(cuda):
    """A forward and backward at the training shape raises the peak by the
    backward's workspace (one chunk's buffers, dh and its part in fp32, h
    repeated three times) and the two gradients, and by nothing the
    workspace does not hold, so that a count of the step's storages sees
    it all; never by a [T, V] fp32 tensor (6.61 GB)."""
    rows, d, vocab = 16 * 2048, 1024, 50432
    h, table, labels = _on_card(rows, d, vocab, torch.bfloat16, False, 0,
                                cuda)
    h.requires_grad_()
    table.requires_grad_()
    vc = vocab_chunk(rows, d, vocab, torch.bfloat16)
    ws = 4 * unembed_ce_workspace_floats(rows, d, vocab, torch.bfloat16, vc,
                                         backward=True)
    grads = rows * d * 2 + d * vocab * 2
    unembed_cross_entropy(h, table, labels).backward()   # cuBLAS's own
    h.grad = table.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    unembed_cross_entropy(h, table, labels).backward()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    print(f"peak rise {rise / 1e9:.3f} GB: workspace {ws / 1e9:.3f} GB, "
          f"gradients {grads / 1e9:.3f} GB")
    assert ws <= rise <= ws + grads + (4 << 20)
    assert rise < rows * vocab * 4
