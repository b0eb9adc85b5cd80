"""The port's hand-written CUDA kernels against their plain PyTorch
versions. The tests marked ``gpu`` need a card and skip without one; this
file imports no JAX, so it runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

Tolerances, by the largest relative L2 error of one output row
(``row_rel_err``): flash attention in bf16 to 2e-2. Its backward's dQ, dK,
dV too, each row's norm raised to at least 1% of the median row norm
(row 0 of dQ is exactly zero under a causal mask); the kernel rounds P and
dS to bf16 before their products and the outputs to bf16, 2^-9 per term.
The forward's LSE to 1e-3 absolute (a 0.1% error in P). Both sides round the
output to bf16 (2^-8 relative at most) and the kernel also rounds P to
bf16 before P @ V, so a sound row errs by a few 1e-3; an absolute limit
cannot serve, since causal rows range in size from ~1 (row 0) to
~1/sqrt(S). The SSD scan: y (bf16, rows over P) to 1e-2 and the fp32 final
state (rows over N) to 1e-3. Both sides start from the same bf16 inputs;
the kernel sums bf16 tensor-core products in fp32 with every fp32 operand
split into a bf16 hi and lo part (~2^-16 relative per term; the error
budget in csrc/ssd.cu), in tiles of 32 instead of chunks of 256, then
both round y to bf16 (2^-9 relative per element).
"""

import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (KEY_TILE, flash_attention,
                                                 flash_attention_bwd,
                                                 wgmma_probe)
from repro_torch.kernels.ops import attention_op, ssd_op
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference, row_rel_err,
                                     ssd_chunked_reference)
from repro_torch.kernels.ssd import ssd_chunked_kernel
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_map
from repro_torch.train.step import loss_and_grads

BF16_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2
LSE_ABS_TOL = 1e-3
SSD_Y_ROW_RTOL = 1e-2
SSD_STATE_ROW_RTOL = 1e-3

# (B, Hq, Hkv, Sq, Sk, D, window): tests/test_kernels.py's grid and
# windows, then the serving path's shapes
SHAPES = [
    (2, 4, 4, 256, 256, 64, 0),      # MHA
    (2, 4, 2, 256, 256, 64, 0),      # GQA 2:1
    (1, 8, 1, 128, 512, 64, 0),      # MQA, rectangular
    (1, 4, 2, 256, 256, 128, 0),     # head_dim 128
    (1, 2, 1, 192, 320, 64, 0),      # non-block-multiple
    (1, 4, 2, 256, 256, 64, 32),     # sliding windows
    (1, 4, 2, 256, 256, 64, 64),
    (1, 4, 2, 256, 256, 64, 100),
    (2, 16, 2, 1000, 1000, 128, 0),  # ragged serving length
    (2, 16, 2, 1024, 1024, 128, 256),
]


def test_flash_attention_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: the plain version
    does, chosen by attention_op."""
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)
    before = flash_attention.launches
    assert attention_op(x, x, x).shape == x.shape
    assert flash_attention.launches == before


def test_flash_attention_bwd_refuses_cpu_tensors():
    """No backward kernel runs on the CPU; there autograd differentiates
    the plain version through attention_op."""
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, lse, x)
    q = torch.randn((1, 64, 2, 64), requires_grad=True)
    before = flash_attention_bwd.launches, flash_attention.launches
    attention_op(q, q, q).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert (flash_attention_bwd.launches, flash_attention.launches) == before


def _ssd_inputs(b, s, h, p, g, n, device="cpu", seed=0):
    """x ~ N(0, 1), dt = softplus(N(0, 1)), A = -exp(U[0, 1]),
    B/C ~ N(0, 1/4), D = 1, as in tests/test_kernels.py; x, B, C bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return (randn(b, s, h, p).bfloat16(),
            torch.nn.functional.softplus(randn(b, s, h)),
            -torch.exp(torch.rand((h,), generator=gen, device=device)),
            (randn(b, s, g, n) * 0.5).bfloat16(),
            (randn(b, s, g, n) * 0.5).bfloat16(),
            torch.ones((h,), device=device))


def test_ssd_kernel_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: the plain version
    does, chosen by ssd_op, and the launch counter stays still."""
    args = _ssd_inputs(1, 40, 2, 32, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_kernel(*args)
    before = ssd_chunked_kernel.launches
    y, st = ssd_op(*args, chunk=32)
    assert y.shape == args[0].shape and y.dtype == torch.bfloat16
    assert st.shape == (1, 2, 32, 16) and st.dtype == torch.float32
    assert ssd_chunked_kernel.launches == before


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()


def test_source_hash_names_the_library():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    for name in ("flash_attention.cu", "flash_attention_bwd.cu", "ssd.cu"):
        assert (build.CSRC / name).is_file()


def test_row_rel_err_finds_one_wrong_row():
    """One row off by 5% among many right ones reads as 5%, though its
    absolute error is far below the largest value."""
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn((2, 300, 4, 64), generator=gen)
    ref[0, 0] *= 40  # a large first row, as causal attention has
    out = ref.clone()
    assert row_rel_err(out, ref) == 0.0
    out[1, 299, 3] *= 1.05
    assert row_rel_err(out, ref) == pytest.approx(0.05, rel=1e-3)
    assert (out - ref).abs().max() < 1e-2 * ref.abs().max()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", SHAPES)
def test_kernel_matches_plain_on_card(cuda, b, hq, hkv, sq, sk, d, window):
    gen = torch.Generator(device=cuda).manual_seed(sq + d + window)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    before = flash_attention.launches
    out = attention_op(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=True, window=window).transpose(1, 2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert row_rel_err(out, ref) <= BF16_ROW_RTOL


# (B, Hq, Hkv, Sq, Sk, D, window, causal): the edges of the TMA + wgmma
# kernel's 128-row q tiles, key tiles and 64-column boxes
HOPPER_EDGES = [
    (1, 4, 2, 1000, 1000, 128, 0, True),    # Sq not a multiple of 128
    (1, 4, 2, 300, 700, 128, 0, True),      # Sk > Sq
    (1, 4, 2, 520, 520, 128, 100, True),    # windows crossing key tiles
    (2, 8, 2, 384, 384, 64, 0, True),       # D = 64: one TMA box
    (1, 4, 2, 256, 333, 128, 0, False),     # non-causal, ragged last tile
    (1, 4, 1, 100, 100, 64, 0, False),      # one q tile, one ragged key tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,causal", HOPPER_EDGES)
def test_kernel_tile_edges_on_card(cuda, b, hq, hkv, sq, sk, d, window,
                                   causal):
    """Non-causal with Sk not a multiple of the key tile is the case in
    which only the `kpos < Sk` mask hides the zero-filled keys."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=causal, window=window).transpose(1, 2)
    assert row_rel_err(out, ref) <= BF16_ROW_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_probe_matches_matmul(cuda, d):
    """The kernel's TMA boxes and wgmma descriptors on one product: S = A
    K^T from shared memory (K-major), O = bf16(S) V with V read MN-major."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    a, k, v = (torch.randn((r, d), generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for r in (64, KEY_TILE, KEY_TILE))
    s, o = wgmma_probe(a, k, v)
    torch.cuda.synchronize()
    s_ref = a.float() @ k.float().T
    o_ref = s.bfloat16().float() @ v.float()
    # fp32 sums of exact bf16 products, in another order
    torch.testing.assert_close(s, s_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(o, o_ref, atol=1e-2, rtol=1e-4)


@pytest.mark.gpu
def test_kernel_reads_strided_views_d128(cuda):
    """q/k/v sliced out of one fused projection at D = 128, with a window:
    the TMA maps take the caller's strides."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 300, 16 + 2 + 2, 128), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
    out = flash_attention(q, k, v, window=100)
    ref = flash_attention(*(t.contiguous() for t in (q, k, v)), window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_kernel_reads_strided_views(cuda):
    """q/k/v sliced out of one fused projection (non-contiguous heads) give
    the same result as contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((2, 200, 8 + 2 + 2, 64), generator=gen, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = flash_attention(q, k, v)
    ref = flash_attention(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(*(torch.zeros((1, 64, 2, 64), device=cuda),) * 3)


# (B, S, H, P, G, N): tests/test_kernels.py's SSD grid, then the serving
# path's shapes (mamba2-370m, 8 prompts padded to 1024; ragged 1000)
SSD_SHAPES = [
    (2, 128, 4, 32, 1, 16),
    (1, 64, 2, 64, 1, 64),
    (1, 128, 4, 64, 1, 128),
    (1, 96, 4, 32, 2, 16),
    (1, 100, 2, 32, 1, 16),
    (8, 1024, 32, 64, 1, 128),
    (8, 1000, 32, 64, 1, 128),
    (2, 512, 8, 64, 2, 64),
    # the tensor-core kernel's edges: one position, one position into a
    # second tile, two groups at N = 128, N = 16 with P = 32
    (2, 1, 4, 64, 1, 128),
    (2, 65, 4, 64, 1, 128),
    (2, 200, 8, 64, 2, 128),
    (2, 130, 4, 32, 1, 16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", SSD_SHAPES)
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n):
    args = _ssd_inputs(b, s, h, p, g, n, device=cuda, seed=s + h)
    before = ssd_chunked_kernel.launches
    y, st = ssd_op(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd_chunked_kernel.launches == before + 1
    y_ref, st_ref = ssd_chunked_reference(*args, chunk=256)
    assert y.dtype == torch.bfloat16 and y.shape == args[0].shape
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    assert row_rel_err(y, y_ref) <= SSD_Y_ROW_RTOL
    assert row_rel_err(st, st_ref) <= SSD_STATE_ROW_RTOL


@pytest.mark.gpu
def test_ssd_kernel_reads_strided_views(cuda):
    """x, B and C sliced out of one fused projection give the same result
    as contiguous copies."""
    b, s, h, p, n = 2, 130, 4, 32, 16
    gen = torch.Generator(device=cuda).manual_seed(0)
    fused = torch.randn((b, s, h * p + 2 * n), generator=gen, device=cuda,
                        dtype=torch.bfloat16)
    x = fused[..., :h * p].unflatten(-1, (h, p))
    B = fused[..., h * p:h * p + n].unsqueeze(2)
    C = fused[..., h * p + n:].unsqueeze(2)
    _, dt, A, _, _, D = _ssd_inputs(b, s, h, p, 1, n, device=cuda)
    y, st = ssd_chunked_kernel(x, dt, A, B, C, D)
    y2, st2 = ssd_chunked_kernel(x.contiguous(), dt, A, B.contiguous(),
                                 C.contiguous(), D)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.gpu
def test_ssd_kernel_rejects_what_it_cannot_take(cuda):
    args = list(_ssd_inputs(1, 64, 2, 48, 1, 16, device=cuda))
    with pytest.raises(ValueError, match="head_dim"):
        ssd_chunked_kernel(*args)
    args = list(_ssd_inputs(1, 64, 2, 32, 1, 32, device=cuda))
    with pytest.raises(ValueError, match="state_dim"):
        ssd_chunked_kernel(*args)
    args = list(_ssd_inputs(1, 64, 2, 32, 1, 16, device=cuda))
    args[0] = args[0].float()
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_chunked_kernel(*args)


# (B, Hq, Hkv, Sq, Sk, D, window, causal): the backward kernels' 64-row q
# tiles and 64- and 128-key blocks, ragged edges, windows crossing tiles,
# D = 64, a group of 1, the training shape, and a grid of several waves
BWD_EDGES = [
    (2, 4, 2, 256, 256, 64, 0, True),
    (1, 4, 2, 1000, 1000, 128, 0, True),    # S not a multiple of 64
    (1, 4, 2, 520, 520, 128, 100, True),    # windows crossing key tiles
    (2, 8, 2, 384, 384, 64, 0, True),       # D = 64
    (1, 4, 2, 256, 333, 128, 0, False),     # non-causal, ragged keys
    (1, 4, 2, 300, 700, 128, 0, True),      # Sk > Sq
    (1, 4, 4, 300, 300, 128, 0, True),      # Hq = Hkv: a group of 1
    (1, 4, 1, 100, 100, 64, 0, False),      # one ragged tile each
    (2, 16, 2, 2048, 2048, 128, 0, True),   # the training shape
    (17, 16, 2, 512, 512, 128, 0, True),    # B * Hq = 272: several waves
]


def _qkv_do(cuda, b, hq, hkv, sq, sk, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device=cuda,
                        dtype=torch.bfloat16)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv), (sq, hq))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,causal", BWD_EDGES)
def test_flash_bwd_matches_plain_on_card(cuda, b, hq, hkv, sq, sk, d, window,
                                         causal):
    q, k, v, do = _qkv_do(cuda, b, hq, hkv, sq, sk, d, sq + sk + d)
    _, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    refs = attention_backward_reference(
        *(t.transpose(1, 2) for t in (q, k, v, do)), causal=causal,
        window=window)
    for g, r, t in zip(grads, refs, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert row_rel_err(g, r.transpose(1, 2),
                           floor=GRAD_ROW_FLOOR) <= BF16_ROW_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,causal", BWD_EDGES[:4])
def test_forward_lse_on_card(cuda, b, hq, hkv, sq, sk, d, window, causal):
    """The LSE against the plain logsumexp; the output with the LSE
    written is bit-equal to the serving call's."""
    q, k, v, _ = _qkv_do(cuda, b, hq, hkv, sq, sk, d, 7)
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)
    plain = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _, lse_ref = attention_lse_reference(
        *(t.transpose(1, 2) for t in (q, k, v)), causal=causal, window=window)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_TOL
    assert torch.equal(out, plain)


@pytest.mark.gpu
def test_attention_op_differentiates_through_the_kernels_on_card(cuda):
    """Under grad, attention_op runs the forward kernel with its LSE and
    autograd calls the backward kernel; gradients match the plain
    backward."""
    q, k, v, do = _qkv_do(cuda, 2, 8, 2, 300, 300, 128, 3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches, flash_attention_bwd.launches
    out = attention_op(*leaves, window=64)
    torch.autograd.backward(out, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    refs = attention_backward_reference(
        *(t.transpose(1, 2) for t in (q, k, v, do)), window=64)
    for leaf, r in zip(leaves, refs):
        assert row_rel_err(leaf.grad, r.transpose(1, 2),
                           floor=GRAD_ROW_FLOOR) <= BF16_ROW_RTOL


@pytest.mark.gpu
def test_tiny_model_trains_through_the_kernels_on_card(cuda):
    """Tiny qwen2.5-3b, bf16 compute over fp32 masters, with and without
    remat: one forward kernel per layer (two with remat: the backward pass
    recomputes each layer) and one backward kernel per layer; the loss and
    every gradient agree with the CPU's plain path (bf16 on both sides,
    rounded in another order: 5e-2 by each leaf's relative L2 error)."""
    cfg = get_tiny("qwen2.5-3b")
    cpu = Model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    g_cpu = tree_map(torch.zeros_like, p_cpu)
    loss_cpu, _ = loss_and_grads(cpu, p_cpu, batch, g_cpu)
    for remat in (True, False):
        gpu = Model(cfg, device=cuda, remat=remat)
        g_gpu = tree_map(torch.zeros_like, p_gpu)
        before = flash_attention.launches, flash_attention_bwd.launches
        loss, _ = loss_and_grads(gpu, p_gpu, tree_map(lambda t: t.to(cuda),
                                                      batch), g_gpu)
        torch.cuda.synchronize()
        fwd = (2 if remat else 1) * cfg.num_layers
        assert (flash_attention.launches - before[0],
                flash_attention_bwd.launches - before[1]) == (
                    fwd, cfg.num_layers)
        assert abs(loss.item() - loss_cpu.item()) <= 5e-2 * loss_cpu.item()
        for name in ("embed", "lm_head", "final_norm"):
            ref = g_cpu[name]
            assert ((g_gpu[name].cpu() - ref).norm() / ref.norm()).item() <= 5e-2
        for name, ref in g_cpu["layers"].items():
            err = (g_gpu["layers"][name].cpu() - ref).norm() / ref.norm()
            assert err.item() <= 5e-2, name


@pytest.mark.gpu
def test_ssd_op_refuses_inputs_that_need_a_gradient_on_card(cuda):
    """The SSD kernel has no backward: its output would carry none."""
    args = list(_ssd_inputs(1, 64, 2, 32, 1, 16, device=cuda))
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_op(*args, chunk=32)
    with torch.no_grad():
        y, _ = ssd_op(*args, chunk=32)
    assert y.shape == args[0].shape
