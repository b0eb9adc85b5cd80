"""Hand-written CUDA flash-attention forward for Hopper, and its launcher.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``. The kernel is
``csrc/flash_attention.cu``; its header says what bounds it on the H100
and what its design does about that. In short: at the prefill shape it is
bound by the tensor cores, and this first version, on ``mma.sync`` with
synchronous tile loads, is bound by load latency instead. Its plain
version is ``repro_torch.kernels.ref.attention_reference``.

Unlike the Pallas wrapper this one takes the model layout
``[B, S, H, D]`` and hands the kernel strides, so nothing is transposed
or padded. It launches on CUDA tensors only and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

_Strides = ctypes.c_longlong * 3
_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.build().lib.repro_flash_attention_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        ptr = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ptr, ptr, ptr, ptr,
                       i, i, p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel runs on CUDA tensors only")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, H, D], "
                             f"got {tuple(t.shape)}")
        # the kernel loads 16-byte vectors along D
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs a unit stride on "
                             "D, other strides a multiple of 8 and a 16-byte "
                             "aligned base")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: {hq} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if b * hq > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} exceeds the "
                         f"grid's {_MAX_GRID_Y}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D], bf16 on CUDA.
    Returns [B, Sq, Hq, D] in bf16."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, out)]
    # the runtime launches on its current device: make it the tensors' one
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, hq, hkv, sq, sk, d, *strides,
                       int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed, cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
