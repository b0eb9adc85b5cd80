"""The training loss's unembedding and cross-entropy as one operator that
walks the vocabulary in chunks, and the launchers of its two CUDA kernels.

The operator replaces no TPU kernel: it replaces the JAX model's jnp
``unembed`` and ``logsumexp`` (``src/repro/models/model.py:643-650``),
bf16 operands into fp32 logits [B, S, V], and ``jax.grad`` through them.
Here the logits of the whole vocabulary never exist. The vocabulary is
walked in chunks of ``vocab_chunk`` columns; each chunk's logits [T, Vc]
are a product of bf16 operands with fp32 accumulation and fp32 output
(``torch.mm(..., out_dtype=torch.float32)`` on the card, the operands
widened exactly on the CPU), never bf16 logits, and then:

* forward (``unembed_ce_fwd_op``): a row reduction folds the chunk into
  each row's running (max, sum of exp) and picks the label's logit where
  the label falls in the chunk (``ce_fold_kernel``); the last chunk writes
  each row's log-sum-exp, and ce = mean(lse - label's logit). It keeps
  ``lse`` [T] fp32 for the backward.
* backward (``unembed_ce_bwd_op``): each chunk's logits are recomputed; a
  fused elementwise pass (``ce_grad_kernel``) forms the softmax gradient in
  fp32, g = (exp(logits - lse) - onehot) * dce / T, the loss's gradient
  taken before the products as the reference takes it, and writes it as
  three bf16 planes hi + mid + lo that sum to g exactly. Both backward
  products then take the planes on bf16 tensor cores with the plane sum
  inside the product: dh += [hi | mid | lo] @ [W_c^T; W_c^T; W_c^T] (the
  planes [T, 3, Vc] read as [T, 3 Vc]) and dW_c = [h; h; h]^T @ the planes
  read as [3 T, Vc] (each row of h repeated three times, in the planes'
  order). Every bf16 x bf16 product is exact in fp32, so the fp32 operand
  loses nothing; no TF32, no two-plane split. dh is summed over the chunks
  in fp32 and rounded to h's dtype once, dW_c to the table's once, as
  autograd of the fp32 upcasts rounded them before.

With fp32 operands (a model computing in fp32) the same chunks run fp32
products on fp32 g, and no planes: the products' precision follows the
operands' dtype.

Memory: every buffer of the loop lies in a workspace that the caller
allocates and passes in (``unembed_ce_workspace_floats``), as the SSD
backward's does, so that a count of the step's storages
(``roofline/step_cost.py``) and the dry run on the meta device see it.
The chunk width bounds all of a chunk's buffers together: its fp32
logits, its planes, the tripled table chunk and dW's fp32 chunk take at
most ``CHUNK_BYTES`` (``vocab_chunk``); beside them lie dh and its part
in fp32 and h repeated three times, 14 T d bytes. At mamba2-370m's
16 x 2048 x 1024 x 50,432 that is 2.37 GB in all, instead of several
[T, V] fp32 tensors (6.61 GB each).

The chunk loop is one piece of code for both devices (``_forward``,
``_backward``); the per-chunk steps take the kernels on a CUDA tensor and
their plain versions (``kernels/ref.py``: ``ce_fold_reference``,
``ce_grad_reference``) on a CPU one, so the CPU tests run the card's
chunking and three-plane split. ``unembed_ce_plain`` runs the loop with
the plain versions on any device, the card's yardstick. A kernel launches
on CUDA tensors only, raises on anything it cannot take and never falls
back. The kernels are ``csrc/unembed_ce.cu``, whose header says what
bounds them.

Both operators are ``torch.library`` operators, as the flash and SSD ones
are: implemented for the CPU and the card by the loop, with fake
implementations for the meta device; each takes its workspace as a
mutable argument, so their autograd is an ``autograd.Function`` in
``kernels/ops.py`` (``unembed_ce_chunked``), which allocates both
workspaces; that module also registers their FLOP formulas, and its
``unembed_cross_entropy`` is the entry point.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ce_fold_reference, ce_grad_reference

# the most bytes one chunk's buffers may take (its fp32 logits, its bf16
# planes, the tripled table chunk, dW's fp32 chunk)
CHUNK_BYTES = 1 << 31
COLUMN_ALIGN = 128  # a chunk's width is a multiple of this, but the last
DTYPES = (torch.bfloat16, torch.float32)
_REGION_ALIGN = 64  # floats: each workspace buffer starts on 256 bytes

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_ce_fold": [_p, _ll, _i, _i, _p, _i, _p, _p, _i, _i, _p],
    "repro_ce_grad": [_p, _ll, _i, _i, _p, _i, _p, _p, _p, _p, _p],
}
_bound: dict = {}


def _entry(name: str):
    if name not in _bound:
        fn = getattr(build.build().lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return _bound[name]


def _column_bytes(rows: int, d: int, planes: bool) -> int:
    """The bytes of a chunk's buffers per column: its fp32 logits (4 T)
    and dW's fp32 chunk (4 d); with bf16 operands also its planes (6 T)
    and the tripled table chunk (6 d)."""
    return 4 * rows + 4 * d + (6 * rows + 6 * d if planes else 0)


def vocab_chunk(rows: int, d: int, vocab: int, dtype: torch.dtype) -> int:
    """The chunk width for ``rows`` positions of width ``d`` over ``vocab``
    columns in ``dtype``, from the shapes alone: the fewest chunks whose
    buffers each fit ``CHUNK_BYTES`` (chunks of at least ``COLUMN_ALIGN``
    columns), then the narrowest multiple of ``COLUMN_ALIGN`` that covers
    the vocabulary in that many, so that the last chunk is not a sliver;
    or the whole vocabulary where that is narrower. 5,632 at mamba2-370m's
    32,768 rows of 1024 over 50,432 in bf16: 9 chunks, the last 5,376."""
    per = _column_bytes(max(rows, 1), d, dtype == torch.bfloat16)
    widest = max(CHUNK_BYTES // per // COLUMN_ALIGN * COLUMN_ALIGN,
                 COLUMN_ALIGN)
    if widest >= vocab:
        return vocab
    even = -(-vocab // -(-vocab // widest))
    return -(-even // COLUMN_ALIGN) * COLUMN_ALIGN


def _check_cuda(who: str, **tensors) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}, the kernel "
                             "runs on CUDA tensors only")
        if t.device != dev:
            raise ValueError(f"{who}: inputs on different devices")
    return dev


def _check_rows(who: str, logits, labels, **per_row) -> None:
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or logits.stride(1) != 1):
        raise ValueError(f"{who}: logits must be 2-d fp32 with a unit last "
                         f"stride, got {logits.dtype} {tuple(logits.shape)} "
                         f"strides {logits.stride()}")
    rows = logits.shape[0]
    if labels.dtype != torch.int32 or labels.shape != (rows,) \
            or not labels.is_contiguous():
        raise ValueError(f"{who}: labels must be contiguous int32 "
                         f"[{rows}], got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    for name, (t, shape) in per_row.items():
        if (t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{who}: {name} must be contiguous fp32 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def ce_fold_kernel(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                   state: torch.Tensor, lse: torch.Tensor, *, first: bool,
                   last: bool) -> None:
    """Folds the chunk ``logits`` [T, w] fp32 (columns ``v0`` .. v0 + w of
    the vocabulary) into ``state`` [3, T] fp32 (each row's running max,
    running sum of exp, the label's logit; ``first`` starts it), in place;
    ``last`` writes each row's log-sum-exp into ``lse`` [T] instead of the
    running pair. ``labels`` [T] int32. ``ref.ce_fold_reference`` is its
    plain version."""
    dev = _check_cuda("ce_fold_kernel", logits=logits, labels=labels,
                      state=state, lse=lse)
    rows, w = logits.shape
    _check_rows("ce_fold_kernel", logits, labels, state=(state, (3, rows)),
                lse=(lse, (rows,)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("repro_ce_fold")(
            logits.data_ptr(), logits.stride(0), rows, w, labels.data_ptr(),
            v0, state.data_ptr(), lse.data_ptr(), int(first), int(last),
            stream)
    if err != 0:
        raise RuntimeError(f"ce_fold_kernel: launch failed, cudaError {err}")
    ce_fold_kernel.launches += 1


def ce_grad_kernel(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                   lse: torch.Tensor, dce: torch.Tensor, *,
                   planes: torch.Tensor | None = None) -> torch.Tensor:
    """The softmax gradient of the chunk ``logits`` [T, w] fp32 (columns
    ``v0`` .. v0 + w) for the mean loss's gradient ``dce`` (0-d fp32, read
    on the card): with ``planes`` ([T, 3, w] bf16, contiguous), its hi,
    mid and lo planes written there; else g in fp32, written over
    ``logits``. Returns what it wrote. ``ref.ce_grad_reference`` is its
    plain version."""
    dev = _check_cuda("ce_grad_kernel", logits=logits, labels=labels,
                      lse=lse, dce=dce)
    rows, w = logits.shape
    _check_rows("ce_grad_kernel", logits, labels, lse=(lse, (rows,)),
                dce=(dce, ()))
    if planes is not None and (
            planes.dtype != torch.bfloat16 or planes.shape != (rows, 3, w)
            or not planes.is_contiguous() or planes.device != dev):
        raise ValueError(f"ce_grad_kernel: planes must be contiguous bf16 "
                         f"[{rows}, 3, {w}] on {dev}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry("repro_ce_grad")(
            logits.data_ptr(), logits.stride(0), rows, w, labels.data_ptr(),
            v0, lse.data_ptr(), dce.data_ptr(),
            None if planes is None else planes.data_ptr(),
            logits.data_ptr() if planes is None else None, stream)
    if err != 0:
        raise RuntimeError(f"ce_grad_kernel: launch failed, cudaError {err}")
    ce_grad_kernel.launches += 1
    return logits if planes is None else planes


ce_fold_kernel.launches = 0
ce_grad_kernel.launches = 0


# ----- the workspace: every buffer of the chunk loop -----

def _regions(rows: int, d: int, chunk: int, dtype: torch.dtype,
             backward: bool) -> list:
    """The workspace's buffers, in order: (name, elements, dtype). Forward:
    a chunk's fp32 logits and the rows' running state [3, T]. Backward:
    the chunk's fp32 logits (g over them with fp32 operands), dW's fp32
    chunk, dh and its part in fp32; with bf16 operands also the planes [T,
    3, Vc], the tripled table chunk [3 Vc, d] and h repeated [3 T, d]."""
    f32, b16 = torch.float32, torch.bfloat16
    if not backward:
        return [("logits", rows * chunk, f32), ("state", 3 * rows, f32)]
    out = [("logits", rows * chunk, f32), ("dw", d * chunk, f32),
           ("dh", rows * d, f32), ("part", rows * d, f32)]
    if dtype == torch.bfloat16:
        out += [("planes", 3 * rows * chunk, b16),
                ("table3", 3 * chunk * d, b16), ("h3", 3 * rows * d, b16)]
    return out


def _floats(n: int, dtype: torch.dtype) -> int:
    """fp32 slots that hold ``n`` elements of ``dtype``, rounded up to a
    whole region."""
    size = -(-n * dtype.itemsize // 4)
    return -(-size // _REGION_ALIGN) * _REGION_ALIGN


def unembed_ce_workspace_floats(rows: int, d: int, vocab: int,
                                dtype: torch.dtype, chunk: int, *,
                                backward: bool) -> int:
    """The fp32 elements of workspace ``unembed_ce_fwd`` (``backward``:
    ``unembed_ce_bwd``) needs for h [rows, d] and a table [d, vocab] in
    ``dtype``, walked ``chunk`` columns at a time, from the shapes alone."""
    chunk = min(chunk, vocab)
    return sum(_floats(n, t)
               for _, n, t in _regions(rows, d, chunk, dtype, backward))


def _carve(workspace: torch.Tensor, rows: int, d: int, chunk: int,
           dtype: torch.dtype, backward: bool) -> dict:
    """The workspace's buffers as flat views, by name."""
    views, at = {}, 0
    for name, n, t in _regions(rows, d, chunk, dtype, backward):
        size = _floats(n, t)
        views[name] = workspace[at:at + size].view(t)[:n]
        at += size
    return views


def _check_workspace(who: str, workspace, h, table, chunk: int,
                     backward: bool) -> None:
    need = unembed_ce_workspace_floats(h.shape[0], h.shape[1],
                                       table.shape[1], h.dtype, chunk,
                                       backward=backward)
    if (workspace.dtype != torch.float32 or workspace.dim() != 1
            or not workspace.is_contiguous() or workspace.numel() < need
            or workspace.device != h.device):
        raise ValueError(f"{who}: workspace must be contiguous 1-d fp32 of "
                         f"at least {need} elements on {h.device}, got "
                         f"{workspace.dtype} {tuple(workspace.shape)} on "
                         f"{workspace.device}")


# ----- the chunk loop, the same on both devices -----

def _product(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
             plain: bool) -> torch.Tensor:
    """``out`` [M, N] fp32 = a @ b: bf16 operands with fp32 accumulation
    and output, or fp32 ones. The plain version widens bf16 operands to
    fp32 first, which is exact, so its products and their sums are the
    same arithmetic."""
    out = out.view(a.shape[0], b.shape[1])
    if plain:
        return torch.mm(a.float(), b.float(), out=out)
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32, out=out)
    return torch.mm(a, b, out=out)


def _check(who: str, h, table, labels, chunk: int) -> None:
    if h.dim() != 2 or table.dim() != 2 or h.shape[1] != table.shape[0]:
        raise ValueError(f"{who}: h [T, d] and table [d, V], got "
                         f"{tuple(h.shape)} and {tuple(table.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"{who}: labels [{h.shape[0]}], got "
                         f"{tuple(labels.shape)}")
    if h.dtype != table.dtype or h.dtype not in DTYPES:
        raise TypeError(f"{who}: h and table in one of {DTYPES}, got "
                        f"{h.dtype} and {table.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{who}: labels are {labels.dtype}; int32 or int64")
    if h.device != table.device or h.device != labels.device:
        raise ValueError(f"{who}: inputs on different devices")
    if chunk < 1:
        raise ValueError(f"{who}: chunk {chunk}")


def _chunks(vocab: int, chunk: int):
    for v0 in range(0, vocab, chunk):
        yield v0, min(v0 + chunk, vocab)


def _forward(h, table, labels, workspace, chunk: int, plain: bool):
    _check("unembed_ce_fwd", h, table, labels, chunk)
    _check_workspace("unembed_ce_fwd", workspace, h, table, chunk, False)
    rows, vocab = h.shape[0], table.shape[1]
    chunk = min(chunk, vocab)
    fold = ce_fold_reference if plain else ce_fold_kernel
    ws = _carve(workspace, rows, h.shape[1], chunk, h.dtype, False)
    state = ws["state"].view(3, rows)
    labels = labels.to(torch.int32).contiguous()
    lse = torch.empty((rows,), dtype=torch.float32, device=h.device)
    for v0, v1 in _chunks(vocab, chunk):
        logits = _product(h, table[:, v0:v1], ws["logits"][:rows * (v1 - v0)],
                          plain)
        fold(logits, labels, v0, state, lse, first=v0 == 0, last=v1 == vocab)
    return (lse - state[2]).mean(), lse


def _backward(h, table, labels, lse, dce, workspace, chunk: int,
              plain: bool):
    _check("unembed_ce_bwd", h, table, labels, chunk)
    _check_workspace("unembed_ce_bwd", workspace, h, table, chunk, True)
    (rows, d), vocab = h.shape, table.shape[1]
    chunk = min(chunk, vocab)
    grad = ce_grad_reference if plain else ce_grad_kernel
    ws = _carve(workspace, rows, d, chunk, h.dtype, True)
    labels = labels.to(torch.int32).contiguous()
    dce = dce.to(torch.float32).contiguous()
    split = h.dtype == torch.bfloat16
    if split:
        # [h; h; h] in the planes' row order: row 3 t + p is h's row t
        h_rows = ws["h3"].view(rows, 3, d)
        h_rows.copy_(h[:, None, :].expand(rows, 3, d))
        h_rows = h_rows.view(3 * rows, d)
    dh = ws["dh"].view(rows, d)
    dtable = torch.empty_like(table)
    for v0, v1 in _chunks(vocab, chunk):
        w, w_c = v1 - v0, table[:, v0:v1]
        logits = _product(h, w_c, ws["logits"][:rows * w], plain)
        if split:
            g = grad(logits, labels, v0, lse, dce,
                     planes=ws["planes"][:rows * 3 * w].view(rows, 3, w))
            table3 = ws["table3"][:3 * w * d].view(3, w, d)
            table3.copy_(w_c.t()[None].expand(3, w, d))
            a, b = g.view(rows, 3 * w), table3.view(3 * w, d)
            h_t, g_t = h_rows.t(), g.view(3 * rows, w)
        else:
            g = grad(logits, labels, v0, lse, dce)
            a, b, h_t, g_t = g, w_c.t(), h.t(), g
        if v0 == 0:
            _product(a, b, dh, plain)
        else:
            dh.add_(_product(a, b, ws["part"], plain))
        dtable[:, v0:v1] = _product(h_t, g_t, ws["dw"][:d * w], plain)
    return torch.empty_like(h).copy_(dh), dtable


def unembed_ce_plain(h: torch.Tensor, table: torch.Tensor,
                     labels: torch.Tensor, dce: torch.Tensor, chunk: int):
    """The operator's plain version, on any device: the same chunk loop
    with the kernels' plain versions (what the CPU runs). Returns (ce, dh,
    dtable) for the loss's gradient ``dce`` (0-d)."""
    (rows, d), vocab = h.shape, table.shape[1]

    def workspace(backward):
        return torch.empty((unembed_ce_workspace_floats(
            rows, d, vocab, h.dtype, chunk, backward=backward),),
            dtype=torch.float32, device=h.device)

    ce, lse = _forward(h, table, labels, workspace(False), chunk, plain=True)
    return (ce, *_backward(h, table, labels, lse, dce, workspace(True), chunk,
                           plain=True))


torch.library.define(
    "repro_torch::unembed_ce_fwd",
    "(Tensor h, Tensor table, Tensor labels, Tensor(a!) workspace, "
    "int chunk) -> (Tensor, Tensor)")
torch.library.define(
    "repro_torch::unembed_ce_bwd",
    "(Tensor h, Tensor table, Tensor labels, Tensor lse, Tensor dce, "
    "Tensor(a!) workspace, int chunk) -> (Tensor, Tensor)")


@torch.library.impl("repro_torch::unembed_ce_fwd", ("cpu", "cuda"))
def _unembed_ce_fwd(h, table, labels, workspace, chunk):
    """h [T, d], table [d, V] (one dtype, bf16 or fp32), labels [T] ->
    (ce, the mean over rows of lse - the label's logit, 0-d fp32;
    lse [T] fp32), walking the vocabulary ``chunk`` columns at a time in
    ``workspace`` (``unembed_ce_workspace_floats`` fp32 elements)."""
    return _forward(h, table, labels, workspace, chunk,
                    plain=h.device.type == "cpu")


@torch.library.register_fake("repro_torch::unembed_ce_fwd")
def _(h, table, labels, workspace, chunk):
    _check("unembed_ce_fwd", h, table, labels, chunk)
    _check_workspace("unembed_ce_fwd", workspace, h, table, chunk, False)
    f32 = dict(dtype=torch.float32)
    return h.new_empty((), **f32), h.new_empty((h.shape[0],), **f32)


@torch.library.impl("repro_torch::unembed_ce_bwd", ("cpu", "cuda"))
def _unembed_ce_bwd(h, table, labels, lse, dce, workspace, chunk):
    """The gradients of ``unembed_ce_fwd``'s ce for its gradient ``dce``
    (0-d): (dh [T, d] in h's dtype, dtable [d, V] in the table's dtype and
    layout), each rounded once from fp32; the loop's buffers in
    ``workspace``."""
    return _backward(h, table, labels, lse, dce, workspace, chunk,
                     plain=h.device.type == "cpu")


@torch.library.register_fake("repro_torch::unembed_ce_bwd")
def _(h, table, labels, lse, dce, workspace, chunk):
    _check("unembed_ce_bwd", h, table, labels, chunk)
    _check_workspace("unembed_ce_bwd", workspace, h, table, chunk, True)
    return torch.empty_like(h), torch.empty_like(table)


unembed_ce_fwd_op = torch.ops.repro_torch.unembed_ce_fwd.default
unembed_ce_bwd_op = torch.ops.repro_torch.unembed_ce_bwd.default
