"""Hand-written CUDA SSD chunked scan for Hopper, forward and backward,
and their launchers.

The forward replaces the Pallas TPU kernel ``_ssd_kernel`` /
``ssd_chunked_kernel`` of ``src/repro/kernels/ssd.py``. The kernel is
``csrc/ssd.cu``; its header says what bounds it on the H100, what its
design does about that and its error budget. In short: all four products
run on tensor cores in bf16, each fp32 operand split into a bf16 hi and lo
part, over tiles of ``chunk`` positions loaded ahead with ``cp.async``: 32
(``TILE``, the default) or 16, the template instances compiled into the
library (``CONFIGS``); ``kernels/ops.py`` resolves the tile from the tuning
profile, and any other raises before a launch. Its plain version is
``repro_torch.kernels.ref.ssd_chunked_reference``.

Each kernel is compiled twice, by the part count of its intra-tile
products (``INTRA_PARTS``): M = (C B^T) exp(cs_i - cs_j) dt_j in the
forward, M and Q in the backward's gradient pass, fed to the tensor cores
as a bf16 hi + lo pair (the default) or as one bf16 part, the
bf16-intra instance: the card's counterpart of the reference's
``Rules.ssd_compute_dtype = "bfloat16"``, whose plain version is
``ssd_chunked_reference(compute_dtype=torch.bfloat16)``. The state and x w
keep both parts in both instances. ``ssd_chunked_kernel_bf16`` and
``ssd_chunked_bwd_kernel_bf16`` launch it, each with its own launch count.

The backward (``csrc/ssd_bwd.cu``) had no TPU kernel: it replaces
``jax.grad`` of the JAX model's ``ssd_chunked``. Three launches: two walks
over the tiles (the state entering each tile, the state gradient leaving
it, stored as bf16 hi / lo planes), a gradient pass per (tile, group)
over the group's heads in order, and the sums of dA / dD; every product
on tensor cores with the forward's hi / lo splits, every sum across blocks
in a fixed order, so two calls give the same bits. Its plain version is
``repro_torch.kernels.ref.ssd_backward_reference``; its algorithm, in
torch, ``ssd_backward_tiles`` (``split=True`` for the kernel's roundings).

Unlike the Pallas wrapper these take the model layout ``[B, S, H, P]`` /
``[B, S, G, N]`` and hand the kernels strides, so nothing is transposed or
padded. The forward's ``chunk`` is its tile along S, not the plain
version's chunk; the backward walks tiles of ``TILE``. They launch on CUDA
tensors only and never fall back.

Both are also PyTorch operators, defined through ``torch.library`` as
the flash kernels are (``kernels/flash_attention.py``): ``ssd_fwd_op``
(``repro_torch::ssd_fwd``) and ``ssd_bwd_op`` (``repro_torch::ssd_bwd``),
whose workspace is an argument, so that whoever allocates it (the
autograd backward in ``kernels/ops.py``) is seen allocating it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE = 32  # positions per tile along S: the forward's default, the backward's
# the forward's tiles compiled into the library, by state dim (every head
# dim has them all, each in both intra instances; csrc/ssd.cu's instances)
CONFIGS = {16: (32, 16), 64: (32, 16), 128: (32, 16)}
# the parts of the intra-tile products' fp32 operands, by the compute dtype
# of the reference's intra-chunk products: the kernels' two instances
INTRA_PARTS = {"float32": 2, "bfloat16": 1}
SUPPORTED_HEAD_DIMS = (32, 64)
SUPPORTED_STATE_DIMS = (16, 64, 128)
_MAX_GRID_YZ = 65535

_Strides = ctypes.c_longlong * 3
_bound = None
_bwd_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.build().lib.repro_ssd_chunked_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        ptr = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ptr, ptr, ptr, ptr, ptr, i, i, p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def shared_memory_bytes(p: int, n: int, chunk: int) -> int:
    """The dynamic shared memory of one forward block at (P, N, chunk), in
    bytes, as the library was compiled (-1: no instance)."""
    fn = build.build().lib.repro_ssd_chunked_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return int(fn(p, n, chunk))


def _bwd_entry():
    """(the backward's entry point, its workspace size in bytes)."""
    global _bwd_bound
    if _bwd_bound is None:
        lib = build.build().lib
        p, i = ctypes.c_void_p, ctypes.c_int
        ptr = ctypes.POINTER(ctypes.c_longlong)
        fn = lib.repro_ssd_chunked_bwd_bf16
        fn.argtypes = [p] * 14 + [i] * 6 + [ptr] * 5 + [i, p]
        fn.restype = ctypes.c_int
        ws = lib.repro_ssd_chunked_bwd_workspace_bytes
        ws.argtypes = [i] * 5
        ws.restype = ctypes.c_longlong
        _bwd_bound = fn, ws
    return _bwd_bound


def _check(who, x, dt, A, B, C, D, dy=None) -> None:
    named = [("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)]
    wide = [("x", x), ("B", B), ("C", C)]
    if dy is not None:
        named.append(("dy", dy))
        wide.append(("dy", dy))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}, the kernel "
                             "runs on CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"{who}: inputs on different devices")
    for name, t in wide:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{who}: {name} is {t.dtype}; the kernel takes "
                            "bfloat16")
        # the kernels read 16-byte vectors along the last axis
        if (t.dim() != 4 or t.stride(-1) != 1
                or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"{who}: {name} must be 4-d with a unit last "
                             "stride, other strides a multiple of 8 and a "
                             "16-byte aligned base, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} is {t.dtype}; the kernel takes "
                            "float32")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or B.shape != C.shape
            or B.shape[:2] != (b, s) or A.shape != (h,) or D.shape != (h,)
            or (dy is not None and dy.shape != x.shape)):
        raise ValueError(
            f"{who}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, D "
            f"{tuple(D.shape)}"
            + ("" if dy is None else f", dy {tuple(dy.shape)}")
            + " disagree")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError(f"{who}: A and D must be contiguous")
    if s < 1 or g < 1 or h % g:
        raise ValueError(f"{who}: S = {s}, {g} groups for {h} heads")
    if p not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{who}: head_dim {p} not in {SUPPORTED_HEAD_DIMS}")
    if n not in SUPPORTED_STATE_DIMS:
        raise ValueError(f"{who}: state_dim {n} not in "
                         f"{SUPPORTED_STATE_DIMS}")
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"{who}: H = {h}, B = {b} exceed the grid's "
                         f"{_MAX_GRID_YZ}")


def check_config(n: int, chunk: int) -> None:
    """Raises ValueError unless a tile of ``chunk`` is compiled at state
    dim ``n`` (a state dim with no instance at all is ``_check``'s to
    refuse): a config is never replaced by another."""
    if n in CONFIGS and chunk not in CONFIGS[n]:
        raise ValueError(f"ssd_chunked_kernel: no compiled instance for "
                         f"chunk {chunk} at state_dim {n}; compiled: "
                         f"{CONFIGS}")


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                       chunk: int = TILE):
    """x [B, S, H, P] bf16; dt [B, S, H] fp32 (> 0); A [H] fp32 (< 0);
    B/C [B, S, G, N] bf16; D [H] fp32; all on one CUDA device; ``chunk``
    the tile along S, one of ``CONFIGS``.
    Returns (y [B, S, H, P] bf16, final_state [B, H, P, N] fp32)."""
    out = _forward(x, dt, A, B, C, D, chunk, INTRA_PARTS["float32"])
    _count(ssd_chunked_kernel, chunk)
    return out


def ssd_chunked_kernel_bf16(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                            D: torch.Tensor, *, chunk: int = TILE):
    """``ssd_chunked_kernel``'s bf16-intra instance: M x with M rounded to
    bf16 once (``INTRA_PARTS["bfloat16"]``); the same arguments and
    returns."""
    out = _forward(x, dt, A, B, C, D, chunk, INTRA_PARTS["bfloat16"])
    _count(ssd_chunked_kernel_bf16, chunk)
    return out


def _count(wrapper, chunk: int) -> None:
    wrapper.launches += 1
    by_config = wrapper.config_launches
    by_config[chunk] = by_config.get(chunk, 0) + 1


def _forward(x, dt, A, B, C, D, chunk: int, m_parts: int):
    check_config(B.shape[-1], chunk)
    _check("ssd_chunked_kernel", x, dt, A, B, C, D)
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
                       *strides, chunk, m_parts, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked_kernel: launch failed, cudaError "
                           f"{err}")
    return y, state


# each instance's launches, and its launches by chunk
for _fn in (ssd_chunked_kernel, ssd_chunked_kernel_bf16):
    _fn.launches = 0
    _fn.config_launches = {}


def ssd_bwd_workspace_bytes(b: int, s: int, h: int, p: int, n: int) -> int:
    """The backward's scratch for these shapes, in bytes, as the library
    reckons it: the state entering each tile and the state gradient
    leaving it, each as bf16 hi and lo planes ([B, H, S / TILE, 2, P, N],
    as many bytes as fp32), and dA / dD per (batch, head, tile)."""
    return int(_bwd_entry()[1](b, s, h, p, n))


def ssd_bwd_workspace_floats(b: int, s: int, h: int, p: int, n: int) -> int:
    """``ssd_bwd_workspace_bytes`` / 4, from the shapes alone (no library):
    csrc/ssd_bwd.cu's ``Workspace``."""
    tiles = -(-s // TILE)
    return 2 * b * h * tiles * p * n + 2 * b * h * tiles


def ssd_chunked_bwd_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                           dy: torch.Tensor, *,
                           workspace: torch.Tensor | None = None):
    """The gradients of ``ssd_chunked_kernel``'s y for the output gradient
    ``dy`` [B, S, H, P] bf16 (x's shape and layout rules), the inputs as
    the forward's, all on one CUDA device; the final state's gradient is
    taken as zero. ``workspace``: contiguous fp32 scratch of at least
    ``ssd_bwd_workspace_bytes`` on x's device, allocated here if not
    given. Returns (dx [B, S, H, P] bf16, ddt [B, S, H] fp32,
    dA [H] fp32, dB [B, S, G, N] bf16, dC [B, S, G, N] bf16, dD [H] fp32),
    the same bits from call to call."""
    out = _backward(x, dt, A, B, C, D, dy, workspace,
                    INTRA_PARTS["float32"])
    ssd_chunked_bwd_kernel.launches += 1
    return out


def ssd_chunked_bwd_kernel_bf16(x: torch.Tensor, dt: torch.Tensor,
                                A: torch.Tensor, B: torch.Tensor,
                                C: torch.Tensor, D: torch.Tensor,
                                dy: torch.Tensor, *,
                                workspace: torch.Tensor | None = None):
    """``ssd_chunked_bwd_kernel``'s bf16-intra instance, the gradient of
    ``ssd_chunked_kernel_bf16``'s y: M and Q rounded to bf16 once; the same
    arguments and returns, two calls bit-equal."""
    out = _backward(x, dt, A, B, C, D, dy, workspace,
                    INTRA_PARTS["bfloat16"])
    ssd_chunked_bwd_kernel_bf16.launches += 1
    return out


def _backward(x, dt, A, B, C, D, dy, workspace, m_parts: int):
    _check("ssd_chunked_bwd_kernel", x, dt, A, B, C, D, dy)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dev = x.device
    fn, workspace_bytes = _bwd_entry()
    need = workspace_bytes(b, s, h, p, n)
    if workspace is None:
        workspace = torch.empty((need // 4,), dtype=torch.float32, device=dev)
    elif (workspace.device != dev or workspace.dtype != torch.float32
          or not workspace.is_contiguous() or 4 * workspace.numel() < need
          or workspace.data_ptr() % 16):
        raise ValueError(f"ssd_chunked_bwd_kernel: workspace must be "
                         f"contiguous, 16-byte aligned fp32 of >= {need} bytes"
                         f" on {dev}, got {workspace.dtype} "
                         f"{tuple(workspace.shape)} on {workspace.device}")
    dx = torch.empty((b, s, h, p), dtype=torch.bfloat16, device=dev)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dA = torch.empty((h,), dtype=torch.float32, device=dev)
    dD = torch.empty((h,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, g, n), dtype=torch.bfloat16, device=dev)
    dC = torch.empty((b, s, g, n), dtype=torch.bfloat16, device=dev)
    strides = [_Strides(*t.stride()[:3]) for t in (x, dt, B, C, dy)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (x, dt, A, B, C, D, dy, dx, ddt, dA,
                                          dB, dC, dD, workspace)),
                 b, s, h, p, g, n, *strides, m_parts, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked_bwd_kernel: launch failed, "
                           f"cudaError {err}")
    return dx, ddt, dA, dB, dC, dD


ssd_chunked_bwd_kernel.launches = 0
ssd_chunked_bwd_kernel_bf16.launches = 0


# bf16_intra: the bf16-intra instance (INTRA_PARTS["bfloat16"])
torch.library.define(
    "repro_torch::ssd_fwd",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D, "
    "int chunk, bool bf16_intra=False) -> (Tensor, Tensor)")
torch.library.define(
    "repro_torch::ssd_bwd",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D, "
    "Tensor dy, Tensor(a!) workspace, bool bf16_intra=False) -> (Tensor, "
    "Tensor, Tensor, Tensor, Tensor, Tensor)")


@torch.library.impl("repro_torch::ssd_fwd", "cuda")
def _ssd_fwd_cuda(x, dt, A, B, C, D, chunk, bf16_intra=False):
    """``ssd_chunked_kernel`` (``bf16_intra``: its bf16-intra instance) as
    an operator: (y, final_state)."""
    fwd = ssd_chunked_kernel_bf16 if bf16_intra else ssd_chunked_kernel
    return fwd(x, dt, A, B, C, D, chunk=chunk)


@torch.library.register_fake("repro_torch::ssd_fwd")
def _(x, dt, A, B, C, D, chunk, bf16_intra=False):
    check_config(B.shape[-1], chunk)
    b, _, h, p = x.shape
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32))


@torch.library.impl("repro_torch::ssd_bwd", "cuda")
def _ssd_bwd_cuda(x, dt, A, B, C, D, dy, workspace, bf16_intra=False):
    """``ssd_chunked_bwd_kernel`` (``bf16_intra``: its bf16-intra instance)
    as an operator, its scratch given: (dx, ddt, dA, dB, dC, dD)."""
    bwd = ssd_chunked_bwd_kernel_bf16 if bf16_intra else ssd_chunked_bwd_kernel
    return bwd(x, dt, A, B, C, D, dy, workspace=workspace)


@torch.library.register_fake("repro_torch::ssd_bwd")
def _(x, dt, A, B, C, D, dy, workspace, bf16_intra=False):
    b, s, h, _ = x.shape
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((b, s, h), **f32), x.new_empty((h,), **f32),
            torch.empty_like(B, memory_format=torch.contiguous_format),
            torch.empty_like(C, memory_format=torch.contiguous_format),
            x.new_empty((h,), **f32))


ssd_fwd_op = torch.ops.repro_torch.ssd_fwd.default
ssd_bwd_op = torch.ops.repro_torch.ssd_bwd.default
