"""The port's hand-written CUDA kernels against their plain PyTorch
versions. The tests marked ``gpu`` need a card and skip without one; this
file imports no JAX, so it runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

Tolerance: in bf16, the largest relative L2 error of one output row
(``row_rel_err``) to 2e-2. Both sides round the output to bf16 (2^-8
relative at most) and the kernel also rounds P to bf16 before P @ V, so a
sound row errs by a few 1e-3; an absolute limit cannot serve, since causal
rows range in size from ~1 (row 0) to ~1/sqrt(S).
"""

import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import attention_op
from repro_torch.kernels.ref import attention_reference, row_rel_err

BF16_ROW_RTOL = 2e-2

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


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()


def test_source_hash_names_the_library():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert (build.CSRC / "flash_attention.cu").is_file()


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
