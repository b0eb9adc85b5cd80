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
both round y to bf16 (2^-9 relative per element). The SSD backward: dx,
ddt, dA, dB, dC and dD each to 2e-2 by the worst row, floored at 1% of the
median row as the flash backward's; the kernel's products are fp32 on exact
widened bf16 inputs, and dx, dB, dC are rounded once to bf16 (2^-9).
"""

import math
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_tiny, reduced
from repro_torch.kernels import build
from repro_torch.kernels import ssd
from repro_torch.kernels.flash_attention import (
    CONFIGS, KEY_TILE, flash_attention, flash_attention_bwd,
    flash_attention_bwd_deterministic, wgmma_probe)
from repro_torch.kernels.ops import attention_op, card_backend, ssd_op
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference, row_rel_err,
                                     ssd_backward_reference,
                                     ssd_chunked_reference)
from repro_torch.kernels.ssd import (ssd_chunked_bwd_kernel,
                                     ssd_chunked_bwd_kernel_bf16,
                                     ssd_chunked_kernel,
                                     ssd_chunked_kernel_bf16)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import tree_map
from repro_torch.train.step import loss_and_grads
from repro_torch.tune import (TuningProfile, attention_key, ssd_key,
                              use_profile)

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


def test_flash_attention_bwd_deterministic_refuses_cpu_tensors():
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    before = flash_attention_bwd_deterministic.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_deterministic(x, x, x, torch.zeros((1, 2, 64)), x)
    assert flash_attention_bwd_deterministic.launches == before


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


def test_bf16_intra_instances_refuse_cpu_tensors():
    """The bf16-intra wrappers never compute on the CPU either: ssd_op's
    compute_dtype picks the plain version's casts there, no launch; an
    unknown compute dtype raises."""
    args = _ssd_inputs(1, 40, 2, 32, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_kernel_bf16(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_bwd_kernel_bf16(*args, args[0])
    before = ssd_chunked_kernel_bf16.launches, ssd_chunked_kernel.launches
    y, st = ssd_op(*args, chunk=32, compute_dtype=torch.bfloat16)
    ry, rst = ssd_chunked_reference(*args, chunk=32,
                                    compute_dtype=torch.bfloat16)
    assert torch.equal(y, ry) and torch.equal(st, rst)
    assert (ssd_chunked_kernel_bf16.launches,
            ssd_chunked_kernel.launches) == before
    with pytest.raises(ValueError, match="compute_dtype"):
        ssd_op(*args, chunk=32, compute_dtype=torch.float16)


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()


def test_source_hash_names_the_library():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    for name in ("flash_attention.cu", "flash_attention_bwd.cu", "ssd.cu",
                 "ssd_bwd.cu"):
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


# every compiled launch config (CONFIGS) at the tile edges of its head dim
CONFIG_EDGES = [(bq, bk, *edge) for edge in HOPPER_EDGES
                for bq, bk in CONFIGS[edge[5]]]


@pytest.mark.gpu
@pytest.mark.parametrize("bq,bk,b,hq,hkv,sq,sk,d,window,causal",
                         CONFIG_EDGES)
def test_every_launch_config_matches_plain_on_card(cuda, bq, bk, b, hq, hkv,
                                                   sq, sk, d, window, causal):
    """Each template instance, its output and its LSE, against the plain
    version; its launch counted under its config."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d + bq + bk)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    before = flash_attention.config_launches.get((bq, bk), 0)
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert flash_attention.config_launches[bq, bk] == before + 1
    ref, lse_ref = attention_lse_reference(
        *(t.transpose(1, 2) for t in (q, k, v)), causal=causal,
        window=window)
    assert row_rel_err(out, ref.transpose(1, 2)) <= BF16_ROW_RTOL
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_TOL


@pytest.mark.gpu
def test_a_config_with_no_instance_raises_on_card(cuda):
    q = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="no compiled instance"):
        flash_attention(q, q, q, block_q=128, block_k=128)
    x, dt, A, B, C, D = _ssd_inputs(1, 40, 2, 32, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="no compiled instance"):
        ssd_chunked_kernel(x, dt, A, B, C, D, chunk=64)


@pytest.mark.gpu
def test_ops_launch_the_profiles_configs_on_card(cuda):
    """Under a profile tuned on this card, attention_op and ssd_op launch
    its entries' configs, the training path (with its backward) too."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 256, 4, 64), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, 256, 2, 64), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    ssd_args = _ssd_inputs(2, 130, 4, 32, 1, 16, device=cuda)
    backend = card_backend()
    prof = TuningProfile(backend=backend)
    prof.record(attention_key(sq=256, sk=256, d=64, g=2, dtype="bfloat16",
                              causal=True, window=0, backend=backend),
                {"block_q": 64, "block_k": 64})
    prof.record(ssd_key(s=130, h=4, p=32, g=1, n=16, dtype="bfloat16",
                        backend=backend), {"chunk": 16})
    flash0 = flash_attention.config_launches.get((64, 64), 0)
    ssd0 = ssd_chunked_kernel.config_launches.get(16, 0)
    with use_profile(prof):
        out = attention_op(q, k, v)
        qg = q.detach().requires_grad_()
        attention_op(qg, k, v).float().sum().backward()
        y, st = ssd_op(*ssd_args, chunk=256)
    torch.cuda.synchronize()
    assert flash_attention.config_launches[64, 64] == flash0 + 2
    assert ssd_chunked_kernel.config_launches[16] == ssd0 + 1
    ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)))
    assert row_rel_err(out, ref.transpose(1, 2)) <= BF16_ROW_RTOL
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    y_ref, st_ref = ssd_chunked_reference(*ssd_args, chunk=256)
    assert row_rel_err(y, y_ref) <= SSD_Y_ROW_RTOL
    assert row_rel_err(st, st_ref) <= SSD_STATE_ROW_RTOL


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
@pytest.mark.parametrize("chunk", [16])
@pytest.mark.parametrize("b,s,h,p,g,n", SSD_SHAPES)
def test_every_ssd_tile_matches_plain_on_card(cuda, chunk, b, s, h, p, g, n):
    """The other compiled tile (the default, 32, runs above through
    ssd_op), against the plain version at the same shapes; its launch
    counted under its tile."""
    assert chunk in ssd.CONFIGS[n] and chunk != ssd.TILE
    args = _ssd_inputs(b, s, h, p, g, n, device=cuda, seed=s + h + chunk)
    before = ssd_chunked_kernel.config_launches.get(chunk, 0)
    y, st = ssd_chunked_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunked_kernel.config_launches[chunk] == before + 1
    y_ref, st_ref = ssd_chunked_reference(*args, chunk=256)
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
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,causal", BWD_EDGES)
def test_flash_bwd_deterministic_on_card(cuda, b, hq, hkv, sq, sk, d, window,
                                         causal):
    """The deterministic backward: within the same tolerance of the plain
    version, and bit-identical across two calls on the same inputs (its
    sums across blocks run in a fixed order)."""
    q, k, v, do = _qkv_do(cuda, b, hq, hkv, sq, sk, d, sq + sk + d)
    _, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    before = (flash_attention_bwd_deterministic.launches,
              flash_attention_bwd.launches)
    first, second = (flash_attention_bwd_deterministic(
        q, k, v, lse, do, causal=causal, window=window) for _ in range(2))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_deterministic.launches,
            flash_attention_bwd.launches) == (before[0] + 2, before[1])
    refs = attention_backward_reference(
        *(t.transpose(1, 2) for t in (q, k, v, do)), causal=causal,
        window=window)
    for g, g2, r, t in zip(first, second, refs, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.equal(g, g2)
        assert row_rel_err(g, r.transpose(1, 2),
                           floor=GRAD_ROW_FLOOR) <= BF16_ROW_RTOL


@pytest.mark.gpu
def test_attention_op_backward_is_deterministic_under_the_switch(cuda):
    """Under torch.use_deterministic_algorithms(True) autograd calls the
    deterministic backward, and two backward passes give the same bits."""
    q, k, v, do = _qkv_do(cuda, 2, 16, 2, 1000, 1000, 128, 5)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        before = (flash_attention_bwd_deterministic.launches,
                  flash_attention_bwd.launches)
        grads = []
        for _ in range(2):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.autograd.backward(attention_op(*leaves), do)
            grads.append([leaf.grad for leaf in leaves])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert (flash_attention_bwd_deterministic.launches,
            flash_attention_bwd.launches) == (before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


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


# (B, S, H, P, G, N) of the SSD backward: the training shape, a ragged S,
# one position into a second tile, two groups, P = 32, N = 16 and 64
SSD_BWD_SHAPES = [
    (8, 2048, 32, 64, 1, 128),
    (2, 1000, 32, 64, 1, 128),
    (2, 33, 4, 64, 1, 128),
    (2, 300, 8, 64, 2, 128),
    (2, 256, 4, 32, 1, 16),
    (2, 200, 8, 64, 2, 64),
    (1, 130, 4, 32, 1, 64),
]


def _ssd_bwd_case(cuda, b, s, h, p, g, n, seed):
    """_ssd_inputs with dt and A as the model draws them (dt log-uniform
    in [1e-3, 1e-1], A = -U[1, 16]), so the state carried between tiles
    matters, and an output gradient dy ~ N(0, 1) in bf16."""
    x, _, _, B, C, D = _ssd_inputs(b, s, h, p, g, n, device=cuda, seed=seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    u = torch.rand((b, s, h), generator=gen, device=cuda)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    A = -(1 + 15 * torch.rand((h,), generator=gen, device=cuda))
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda).bfloat16()
    return (x, dt, A, B, C, D), dy


def test_ssd_bwd_kernel_refuses_cpu_tensors():
    """No backward kernel runs on the CPU; there autograd differentiates
    the plain version through ssd_op."""
    args = _ssd_inputs(1, 40, 2, 32, 1, 16)
    before = ssd_chunked_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_bwd_kernel(*args, args[0])
    leaves = [t.clone().requires_grad_() for t in args]
    y, _ = ssd_op(*leaves, chunk=32)
    y.float().sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert ssd_chunked_bwd_kernel.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", SSD_BWD_SHAPES)
def test_ssd_bwd_matches_plain_on_card(cuda, b, s, h, p, g, n):
    """dx, ddt, dA, dB, dC, dD against autograd of the plain version in
    fp32 from the same bf16 inputs, each by its worst row, floored."""
    args, dy = _ssd_bwd_case(cuda, b, s, h, p, g, n, seed=s + h)
    before = ssd_chunked_bwd_kernel.launches
    got = ssd_chunked_bwd_kernel(*args, dy)
    torch.cuda.synchronize()
    assert ssd_chunked_bwd_kernel.launches == before + 1
    refs = ssd_backward_reference(*args, dy, chunk=256)
    for name, t, r, x in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                             refs, args):
        assert t.shape == x.shape and t.dtype == x.dtype, name
        assert row_rel_err(t, r, floor=GRAD_ROW_FLOOR) <= BF16_ROW_RTOL, name


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", SSD_BWD_SHAPES[1:4])
def test_ssd_bwd_is_deterministic_on_card(cuda, b, s, h, p, g, n):
    """Its sums across blocks run in a fixed order: two calls on the same
    inputs give the same bits."""
    args, dy = _ssd_bwd_case(cuda, b, s, h, p, g, n, seed=7)
    first = ssd_chunked_bwd_kernel(*args, dy)
    second = ssd_chunked_bwd_kernel(*args, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
def test_ssd_op_differentiates_through_the_kernels_on_card(cuda):
    """Under grad, ssd_op runs the forward kernel and autograd the
    backward kernel, once each, with a non-contiguous output gradient; a
    gradient reaching the final state raises rather than go missing."""
    args, dy = _ssd_bwd_case(cuda, 2, 300, 8, 64, 2, 128, seed=3)
    leaves = [t.detach().requires_grad_() for t in args]
    before = ssd_chunked_kernel.launches, ssd_chunked_bwd_kernel.launches
    y, state = ssd_op(*leaves, chunk=256)
    dy_t = dy.transpose(0, 1).contiguous().transpose(0, 1)
    torch.autograd.backward(y, dy_t)
    torch.cuda.synchronize()
    assert (ssd_chunked_kernel.launches, ssd_chunked_bwd_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    refs = ssd_backward_reference(*args, dy, chunk=256)
    for leaf, r in zip(leaves, refs):
        assert row_rel_err(leaf.grad, r, floor=GRAD_ROW_FLOOR) <= BF16_ROW_RTOL
    y, state = ssd_op(*leaves, chunk=256)
    with pytest.raises(NotImplementedError, match="final state"):
        (y.float().sum() + state.sum()).backward()


@pytest.mark.gpu
def test_ssd_op_bf16_compute_runs_the_bf16_intra_instances_on_card(cuda):
    """ssd_op(compute_dtype=bf16) launches the forward's bf16-intra
    instance and autograd the backward's, once each, never the default
    ones; each moves y and dx off the default instance's (one bf16 part
    of M, under the JAX tests' draws) and stays finite; two backward
    calls bit-equal."""
    args = _ssd_inputs(2, 300, 8, 64, 2, 128, device=cuda, seed=5)
    dy = torch.randn(args[0].shape, device=cuda).bfloat16()
    leaves = [t.detach().requires_grad_() for t in args]
    kernels = (ssd_chunked_kernel, ssd_chunked_bwd_kernel,
               ssd_chunked_kernel_bf16, ssd_chunked_bwd_kernel_bf16)
    before = [k.launches for k in kernels]
    y, _ = ssd_op(*leaves, chunk=256, compute_dtype=torch.bfloat16)
    torch.autograd.backward(y, dy)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [0, 0, 1, 1]
    y2, _ = ssd_chunked_kernel(*args)
    dx2 = ssd_chunked_bwd_kernel(*args, dy)[0]
    assert torch.isfinite(y.float()).all()
    assert row_rel_err(y, y2) > SSD_Y_ROW_RTOL
    assert row_rel_err(leaves[0].grad, dx2) > SSD_Y_ROW_RTOL
    first = ssd_chunked_bwd_kernel_bf16(*args, dy)
    second = ssd_chunked_bwd_kernel_bf16(*args, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_ssd_bwd_rejects_what_it_cannot_take(cuda):
    args, dy = _ssd_bwd_case(cuda, 1, 64, 2, 32, 1, 16, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_chunked_bwd_kernel(*args, dy.float())
    with pytest.raises(ValueError, match="dy"):
        ssd_chunked_bwd_kernel(*args, dy[:, :32])


@pytest.mark.gpu
def test_tiny_mamba_trains_through_the_kernels_on_card(cuda):
    """Tiny mamba2-370m, bf16 compute over fp32 masters, with and without
    remat: one SSD forward kernel per layer (two with remat) and one
    backward kernel per layer; the loss and every gradient agree with the
    CPU's plain path (bf16 on both sides, rounded in another order: 5e-2
    by each leaf's relative L2 error)."""
    cfg = get_tiny("mamba2-370m")
    cpu = Model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 101), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    g_cpu = tree_map(torch.zeros_like, p_cpu)
    loss_cpu, _ = loss_and_grads(cpu, p_cpu, batch, g_cpu)
    for remat in (True, False):
        gpu = Model(cfg, device=cuda, remat=remat)
        g_gpu = tree_map(torch.zeros_like, p_gpu)
        before = ssd_chunked_kernel.launches, ssd_chunked_bwd_kernel.launches
        loss, _ = loss_and_grads(gpu, p_gpu, tree_map(lambda t: t.to(cuda),
                                                      batch), g_gpu)
        torch.cuda.synchronize()
        fwd = (2 if remat else 1) * cfg.num_layers
        assert (ssd_chunked_kernel.launches - before[0],
                ssd_chunked_bwd_kernel.launches - before[1]) == (
                    fwd, cfg.num_layers)
        assert abs(loss.item() - loss_cpu.item()) <= 5e-2 * loss_cpu.item()
        for name in ("embed", "lm_head", "final_norm"):
            ref = g_cpu[name]
            assert ((g_gpu[name].cpu() - ref).norm() / ref.norm()).item() <= 5e-2
        for name, ref in g_cpu["layers"].items():
            err = (g_gpu["layers"][name].cpu() - ref).norm() / ref.norm()
            assert err.item() <= 5e-2, name


@pytest.mark.gpu
def test_tiny_zamba_serves_and_trains_through_the_kernels_on_card(cuda):
    """Tiny zamba2-1.2b with five layers (the shared block before layers
    0, 2 and 4, its window of 64 below the 100 positions), bf16 compute
    over fp32 masters: a prefill launches the flash forward once per call
    and the SSD forward once per layer, and its logits agree with the
    CPU's plain path; a training step with remat launches each forward
    twice and each backward once, and the loss and every gradient, the
    shared block's among them, agree with the CPU's (5e-2 by each leaf's
    relative L2 error, as for the other families)."""
    cfg = reduced(get_config("zamba2-1.2b"), num_layers=5)
    cpu = Model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 101), generator=gen)
    gpu = Model(cfg, device=cuda)
    counters = (flash_attention, ssd_chunked_kernel, flash_attention_bwd,
                ssd_chunked_bwd_kernel)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        logits, _ = gpu.prefill(p_gpu, {"tokens": toks[:, :-1].to(cuda)},
                                cache_len=128)
        ref, _ = cpu.prefill(p_cpu, {"tokens": toks[:, :-1]}, cache_len=128)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [3, 5, 0, 0]
    assert row_rel_err(logits.cpu(), ref) <= 3e-2
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    g_cpu = tree_map(torch.zeros_like, p_cpu)
    loss_cpu, _ = loss_and_grads(cpu, p_cpu, batch, g_cpu)
    g_gpu = tree_map(torch.zeros_like, p_gpu)
    before = [fn.launches for fn in counters]
    loss, _ = loss_and_grads(gpu, p_gpu,
                             tree_map(lambda t: t.to(cuda), batch), g_gpu)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [6, 10, 3, 5]
    assert abs(loss.item() - loss_cpu.item()) <= 5e-2 * loss_cpu.item()
    for part in ("layers", "shared_attn"):
        for name, ref in g_cpu[part].items():
            err = (g_gpu[part][name].cpu() - ref).norm() / ref.norm()
            assert err.item() <= 5e-2, (part, name)
