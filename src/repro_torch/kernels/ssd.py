"""Hand-written CUDA SSD chunked scan for Hopper, and its launcher.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_chunked_kernel`` of
``src/repro/kernels/ssd.py``. The kernel is ``csrc/ssd.cu``; its header
says what bounds it on the H100, what its design does about that and its
error budget. In short: all four products run on tensor cores in bf16,
each fp32 operand split into a bf16 hi and lo part, over tiles of
``TILE`` positions loaded ahead with ``cp.async``. Its plain version is
``repro_torch.kernels.ref.ssd_chunked_reference``.

Unlike the Pallas wrapper this one takes the model layout ``[B, S, H, P]``
/ ``[B, S, G, N]`` and hands the kernel strides, so nothing is transposed
or padded; the kernel walks the sequence in its own tiles, so there is no
``chunk`` argument. It launches on CUDA tensors only and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE = 32  # positions per tile along S: csrc/ssd.cu's kTile
SUPPORTED_HEAD_DIMS = (32, 64)
SUPPORTED_STATE_DIMS = (16, 64, 128)
_MAX_GRID_YZ = 65535

_Strides = ctypes.c_longlong * 3
_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.build().lib.repro_ssd_chunked_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        ptr = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ptr, ptr, ptr, ptr, ptr, p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _check(x, dt, A, B, C, D) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_chunked_kernel: {name} is on {t.device}, "
                             "the kernel runs on CUDA tensors only")
        if t.device != x.device:
            raise ValueError("ssd_chunked_kernel: inputs on different devices")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd_chunked_kernel: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        # the kernel copies 16-byte vectors along the last axis
        if (t.dim() != 4 or t.stride(-1) != 1
                or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"ssd_chunked_kernel: {name} must be 4-d with a "
                             "unit last stride, other strides a multiple of "
                             "8 and a 16-byte aligned base, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunked_kernel: {name} is {t.dtype}; the "
                            "kernel takes float32")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or B.shape != C.shape
            or B.shape[:2] != (b, s) or A.shape != (h,) or D.shape != (h,)):
        raise ValueError(
            f"ssd_chunked_kernel: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, D {tuple(D.shape)} disagree")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_chunked_kernel: A and D must be contiguous")
    if s < 1 or g < 1 or h % g:
        raise ValueError(f"ssd_chunked_kernel: S = {s}, {g} groups for {h} "
                         "heads")
    if p not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"ssd_chunked_kernel: head_dim {p} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if n not in SUPPORTED_STATE_DIMS:
        raise ValueError(f"ssd_chunked_kernel: state_dim {n} not in "
                         f"{SUPPORTED_STATE_DIMS}")
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"ssd_chunked_kernel: H = {h}, B = {b} exceed the "
                         f"grid's {_MAX_GRID_YZ}")


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """x [B, S, H, P] bf16; dt [B, S, H] fp32 (> 0); A [H] fp32 (< 0);
    B/C [B, S, G, N] bf16; D [H] fp32; all on one CUDA device.
    Returns (y [B, S, H, P] bf16, final_state [B, H, P, N] fp32)."""
    _check(x, dt, A, B, C, D)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = [_Strides(*t.stride()[:3]) for t in (x, dt, B, C, y)]
    # the runtime launches on its current device: make it the tensors' one
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), D.data_ptr(),
                       y.data_ptr(), state.data_ptr(), b, s, h, p, g, n,
                       *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked_kernel: launch failed, cudaError "
                           f"{err}")
    ssd_chunked_kernel.launches += 1
    return y, state


ssd_chunked_kernel.launches = 0
