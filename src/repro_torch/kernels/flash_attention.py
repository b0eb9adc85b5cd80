"""Hand-written CUDA flash attention for Hopper, forward and backward, and
their launchers.

The forward replaces the Pallas TPU kernel ``_flash_kernel`` /
``flash_attention`` of ``src/repro/kernels/flash_attention.py``. The kernel
is ``csrc/flash_attention.cu``; its header says what bounds it on the H100
and what its design does about that. In short: at the prefill shape it is
bound by the tensor cores, so a producer warpgroup keeps TMA loads of K/V
tiles in flight while two consumer warpgroups run both products on
``wgmma``. With ``return_lse`` (training) it also writes each row's
log-sum-exp, from which the backward recomputes P.
Its plain version is ``repro_torch.kernels.ref.attention_reference``
(``attention_lse_reference`` with the LSE).

The backward, ``flash_attention_bwd``, replaces ``jax.grad`` of the JAX
model's ``chunked_attention`` (no Pallas backward exists): three kernels in
``csrc/flash_attention_bwd.cu`` on TMA and ``wgmma`` (delta = rowsum(P o
dP) exactly; dV, dK and dQ's partials per 64-key tile, summed in fp32;
the conversion to bf16). Its plain version is
``repro_torch.kernels.ref.attention_backward_reference``.

Unlike the Pallas wrapper this one takes the model layout
``[B, S, H, D]`` and hands the kernel strides, from which it builds its
TMA tensor maps, so nothing is transposed or padded. It launches on CUDA
tensors only and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KEY_TILE = 64  # keys per tile: csrc/flash_attention.cu's kBlockK
# csrc/flash_attention_bwd.cu's q tile and key tile, to which its fp32
# scratch is padded
BWD_Q_TILE, BWD_KEY_TILE = 64, 64
SUPPORTED_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

_Strides = ctypes.c_longlong * 3
_p, _i = ctypes.c_void_p, ctypes.c_int
_s = ctypes.POINTER(ctypes.c_longlong)
# the C entry points of csrc/flash_attention.cu and their arguments
_SIGNATURES = {
    "repro_flash_attention_fwd_bf16":
        [_p] * 5 + [_i] * 6 + [_s] * 4 + [_i, _i, _p],
    "repro_flash_attention_bwd_bf16":
        [_p] * 11 + [_i] * 6 + [_s] * 7 + [_i, _i, _p],
    "repro_flash_wgmma_probe_bf16": [_p, _p, _p, _p, _p, _i, _p],
}
_bound = {}


def _entry(name: str = "repro_flash_attention_fwd_bf16"):
    if name not in _bound:
        fn = getattr(build.build().lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return _bound[name]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    """q, k, v and any ``more`` tensors of the model layout (dO: q's shape)
    on one CUDA device, bf16, with the strides the kernels take."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel runs on CUDA tensors only")
        if t.device != q.device:
            raise ValueError("flash_attention: inputs on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, H, D], "
                             f"got {tuple(t.shape)}")
        # TMA: 16-byte aligned base and strides
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs a unit stride on "
                             "D, other strides a multiple of 8 and a 16-byte "
                             "aligned base")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} is "
                             f"not q's shape {tuple(q.shape)}")
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
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D], bf16 on CUDA.
    Returns o [B, Sq, Hq, D] in bf16, and with ``return_lse`` (o, lse):
    lse [B, Hq, Sq] fp32, the logsumexp over each row's visible keys of the
    scaled scores (natural log), as ``flash_attention_bwd`` takes it."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, out)]
    # the runtime launches on its current device: make it the tensors' one
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                       b, hq, hkv, sq, sk, d, *strides, int(causal),
                       int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed, cudaError {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The gradients of ``flash_attention(q, k, v)`` for the output
    gradient ``do``, given the forward's ``lse`` (``return_lse``). q, do:
    [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D], bf16 on CUDA; lse [B, Hq, Sq]
    contiguous fp32. Returns (dq, dk, dv) in bf16, contiguous, in q's, k's
    and v's shapes; dk and dv sum over each kv head's group of q heads.
    The output itself is not needed: the kernels take delta = rowsum(P o
    dP) from a pass of their own rather than rowsum(dO o O) from the
    forward's output, whose bf16 rounding of P moves rows of dQ by up to
    ~5% (csrc/flash_attention_bwd.cu). dQ, dK and dV are sums across
    blocks by fp32 atomics, so their low bits may vary from call to call."""
    _check(q, k, v, do=do)
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, hq, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous fp32 "
                         f"{(b, hq, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    # fp32 scratch: each row's LSE * log2 e and delta, and dQ's sum, written
    # by the delta kernel; dK's and dV's sums, added into from zero
    sq_pad = -(-sq // BWD_Q_TILE) * BWD_Q_TILE
    sk_pad = -(-sk // BWD_KEY_TILE) * BWD_KEY_TILE
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = torch.empty((2, b * hq, sq_pad), **f32)
    dq_acc = torch.empty((b * hq, sq_pad, d), **f32)
    dkv_acc = torch.zeros((2, b * hkv, sk_pad, d), **f32)
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, do, dq, dk, dv)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry("repro_flash_attention_bwd_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), rows.data_ptr(), dq_acc.data_ptr(),
            dkv_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, hkv, sq, sk, d, *strides, int(causal), int(window),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: launch failed, cudaError "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def wgmma_probe(a: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The kernel's TMA boxes and ``wgmma`` descriptors rehearsed on one
    product: a [64, D], k/v [KEY_TILE, D] contiguous bf16 on CUDA.
    Returns (a @ k.T, bf16(a @ k.T) @ v), both fp32. Not on any model
    path."""
    d, kt = a.shape[1], KEY_TILE
    if (a.shape != (64, d) or k.shape != (kt, d) or v.shape != (kt, d)
            or d not in SUPPORTED_HEAD_DIMS):
        raise ValueError(f"wgmma_probe: a [64, D], k/v [{kt}, D], D in "
                         f"{SUPPORTED_HEAD_DIMS}")
    for t in (a, k, v):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or not t.is_contiguous()):
            raise ValueError("wgmma_probe: contiguous bf16 CUDA tensors only")
    s = torch.empty((64, kt), dtype=torch.float32, device=a.device)
    o = torch.empty((64, d), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry("repro_flash_wgmma_probe_bf16")(
            a.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), d, stream)
    if err != 0:
        raise RuntimeError(f"wgmma_probe: launch failed, cudaError {err}")
    return s, o
