"""Kernel entry points in the model's tensor layout, with launch configs
resolved from the ambient :class:`~repro_torch.tune.profile.TuningProfile`.

A tensor on the CPU goes to the plain version, through which autograd
differentiates, and takes no launch config; a CUDA tensor goes to the
hand-written kernel, which raises on anything it cannot take. No path falls
back from the kernel to the plain version, and no kernel output that needs
a gradient lacks one: on the card attention and the SSD scan differentiate
through their backward kernels. The training loss's unembedding and
cross-entropy (``unembed_cross_entropy``) is one operator on both devices,
its chunk loop shared: the card's chunks run its kernels, the CPU's their
plain versions, and its autograd (``unembed_ce_chunked``, an
``autograd.Function`` that allocates both operators' workspaces) takes its
backward operator on both.

The kernels are reached as PyTorch operators (``torch.library``
operators, defined beside their launchers): this module registers their
autograd, the forwards' backward being the backward operators, and their
FLOP formulas (``torch.utils.flop_counter``), taken from
``roofline/kernel_cost.py``, so that a step's count
(``roofline/step_cost.py``), the kernels' bounds and the autotuner's
pruning share one source. A meta tensor takes the same operators, whose
fake implementations give the outputs' shapes: the dry run
(``launch/dryrun.py``) builds a step on the meta device with them.

Config resolution on the card (a port of the JAX package's
``kernels/ops.py``): caller-supplied kwargs win; otherwise the ambient
profile (installed at boot by the BootSeer ``tune.restore`` task, or by
``ServeEngine(tune_profile=)``) is consulted per ``(kernel, shape-bucket,
dtype, backend)``, the backend naming the card (``card_backend``), so a
profile tuned on another card misses; otherwise the defaults, the
kernels' own. A profile with ``tune_on_miss`` set tunes an unseen key once
on first use and publishes the updated profile back through its store
(record-on-miss). A config the kernel has no instance of raises in its
wrapper; it is never replaced by the default. A meta tensor names no card,
so no profile is consulted for it: it takes the defaults.
"""

from __future__ import annotations

import threading
import warnings

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import (
    DEFAULT_CONFIG, flash_attention_bwd_op, flash_attention_fwd_op)
from repro_torch.kernels.ref import attention_reference, ssd_chunked_reference
from repro_torch.kernels.ssd import (INTRA_PARTS, TILE, ssd_bwd_op,
                                     ssd_bwd_workspace_floats, ssd_fwd_op)
from repro_torch.kernels.unembed_ce import (unembed_ce_bwd_op,
                                            unembed_ce_fwd_op,
                                            unembed_ce_workspace_floats,
                                            vocab_chunk)
from repro_torch.roofline.kernel_cost import (ssd_bwd_flops, ssd_flops,
                                              unembed_ce_flops,
                                              unmasked_pairs)
from repro_torch.tune.profile import attention_key, get_active_profile, ssd_key

# the kernels' own launch configs, where neither a caller nor the profile
# names one
DEFAULT_ATTENTION = dict(zip(("block_q", "block_k"), DEFAULT_CONFIG))
DEFAULT_SSD = {"chunk": TILE}

stats = {"profile_hits": 0, "profile_misses": 0, "miss_tunes": 0}

_warn_lock = threading.Lock()
_warned: set = set()


def _warn_once(tag: str, msg: str) -> None:
    with _warn_lock:
        if tag in _warned:
            return
        _warned.add(tag)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def card_backend(device=None) -> str | None:
    """The profile keys' backend for the card ``device`` (the current one
    by default): the kernels' target and the card's name; None for the
    meta device, which names no card."""
    if device is not None and torch.device(device).type == "meta":
        return None
    return f"cuda-sm_90a:{torch.cuda.get_device_name(device)}"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``, as the profile keys spell it."""
    return str(dtype).removeprefix("torch.")


def _resolve(kernel: str, key: str | None, supplied: dict, defaults: dict,
             tune_kwargs: dict) -> dict:
    """Launch config for ``key``: supplied kwargs > ambient profile >
    defaults (field-wise: a caller may pin block_q and let the profile
    pick block_k). No key (no card): the profile is not consulted."""
    cfg = dict(defaults)
    prof = get_active_profile() if key is not None else None
    if prof is not None:
        hit = prof.resolve(key)
        if hit is None and prof.tune_on_miss:
            from repro_torch.tune import autotune
            stats["miss_tunes"] += 1
            try:
                _, entry = autotune.tune_workload(
                    dict(kernel=kernel, **tune_kwargs),
                    backend=prof.backend, profile=prof)
                hit = dict(entry["config"])
                if prof.store is not None:
                    prof.store.publish(prof)
            except Exception as e:  # noqa: BLE001 - tuning must not
                _warn_once(f"{kernel}.miss_tune",  # break a forward pass
                           f"{kernel}: record-on-miss tuning failed "
                           f"({e!r}); using defaults")
        if hit is None:
            stats["profile_misses"] += 1
        else:
            stats["profile_hits"] += 1
            cfg.update({k: v for k, v in hit.items() if k in defaults})
    cfg.update({k: v for k, v in supplied.items() if v is not None})
    return cfg


def attention_config(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                     window: int, block_q: int | None = None,
                     block_k: int | None = None) -> dict:
    """The flash forward's launch config for these card tensors (model
    layout), by ``_resolve``. The key holds (Sq, Sk, D, the GQA group,
    dtype, causal, window), not a q position offset: a sequence shard
    (``attention_op(q_offset=)``) takes the config of its own (Sq, Sk),
    whose tiles are the same; only which key tiles a q tile walks moves."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dtype = dtype_name(q.dtype)
    backend = card_backend(q.device)
    key = backend and attention_key(sq=sq, sk=sk, d=d, g=hq // hkv,
                                    dtype=dtype, causal=causal,
                                    window=window, backend=backend)
    return _resolve(
        "flash_attention", key, {"block_q": block_q, "block_k": block_k},
        DEFAULT_ATTENTION,
        dict(b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, dtype=dtype,
             causal=causal, window=window))


def ssd_config(x: torch.Tensor, B: torch.Tensor) -> dict:
    """The SSD forward's launch config (its tile) for these card tensors,
    by ``_resolve`` from the profile or the default alone: the model's
    chunk (the rules' ``ssm_chunk``) is the plain version's and never
    reaches it. The bf16-intra instance takes the tile resolved here, under
    the same key: the tile moves the result by rounding only, and the
    profile's keys stay the reference's."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dtype = dtype_name(x.dtype)
    backend = card_backend(x.device)
    key = backend and ssd_key(s=s, h=h, p=p, g=g, n=n, dtype=dtype,
                              backend=backend)
    return _resolve("ssd", key, {}, DEFAULT_SSD,
                    dict(b=b, s=s, h=h, p=p, g=g, n=n, dtype=dtype))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, q_offset = inputs[:6]
    ctx.save_for_backward(q, k, v, output[1])
    ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
    ctx.set_materialize_grads(False)


def _flash_backward(ctx, dout, _dlse):
    """The backward kernel: the counterpart of ``jax.grad`` through the JAX
    model's attention. Under ``torch.use_deterministic_algorithms(True)``
    it sums in a fixed order, so its gradients are bit-identical from call
    to call, as ``jax.grad``'s are. The LSE takes no gradient."""
    if dout is None:
        return (None,) * 9
    q, k, v, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(
        q, k, v, lse, dout.contiguous(), ctx.causal, ctx.window, ctx.q_offset,
        torch.are_deterministic_algorithms_enabled())
    return dq, dk, dv, None, None, None, None, None, None


torch.library.register_autograd("repro_torch::flash_attention_fwd",
                                _flash_backward, setup_context=_flash_setup)


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, q_offset: int = 0,
                 block_q: int | None = None,
                 block_k: int | None = None) -> torch.Tensor:
    """Model layout: q [B, Sq, Hq, Dh], k/v [B, Sk, Hkv, Dh] ->
    [B, Sq, Hq, Dh]; row r of q stands at position r + ``q_offset``, key j
    at j (a sequence shard's rows against the gathered keys).
    ``block_q``/``block_k`` pin the kernel's launch config
    (``attention_config``); the CPU's plain version takes none. Under grad
    the forward also writes the LSE its backward takes."""
    if q.device.type == "cpu":
        if block_q is not None or block_k is not None:
            raise ValueError("attention_op: a launch config is the card "
                             "kernel's; the CPU runs the plain version")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = attention_reference(qt, kt, vt, causal=causal, window=window,
                                  q_offset=q_offset)
        return out.transpose(1, 2)
    cfg = attention_config(q, k, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return flash_attention_fwd_op(q, k, v, causal, window, q_offset,
                                  cfg["block_q"], cfg["block_k"], grad)[0]


def _ssd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:6])
    ctx.bf16_intra = inputs[7]  # the backward of the forward's instance
    ctx.set_materialize_grads(False)


def _ssd_backward(ctx, dy, dstate):
    """The backward kernel: the counterpart of ``jax.grad`` through the JAX
    model's ``ssd_chunked``, bit-identical from call to call as that is.
    The final state's gradient is not computed (the train path drops the
    state): a caller whose loss reaches the state gets an error, not a
    gradient without that part."""
    if dstate is not None:
        raise NotImplementedError(
            "ssd_op: the SSD backward kernel takes no gradient of the "
            "final state; drop the state, or differentiate on the CPU")
    if dy is None:
        return (None,) * 8
    x, dt, A, B, C, D = ctx.saved_tensors
    b, s, h, p = x.shape
    workspace = torch.empty(
        (ssd_bwd_workspace_floats(b, s, h, p, B.shape[-1]),),
        dtype=torch.float32, device=x.device)
    return (*ssd_bwd_op(x, dt, A, B, C, D, dy.contiguous(), workspace,
                        ctx.bf16_intra),
            None, None)


torch.library.register_autograd("repro_torch::ssd_fwd", _ssd_backward,
                                setup_context=_ssd_setup)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, chunk: int,
           compute_dtype: torch.dtype = torch.float32):
    """Model layout: x [B, S, H, P], dt [B, S, H], A/D [H], B/C [B, S, G, N]
    -> (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] fp32).
    ``chunk`` is the plain version's chunk, as the JAX model passes it; the
    kernel's tile along S comes from ``ssd_config``. ``compute_dtype`` is
    the intra-chunk products' type (the reference's
    ``Rules.ssd_compute_dtype``): the plain version's casts, or on the card
    the kernels' instance of that name (``INTRA_PARTS``), whose backward
    autograd then runs."""
    name = dtype_name(compute_dtype)
    if name not in INTRA_PARTS:
        raise ValueError(f"ssd_op: compute_dtype {compute_dtype}; one of "
                         f"{sorted(INTRA_PARTS)}")
    if x.device.type == "cpu":
        return ssd_chunked_reference(x, dt, A, B, C, D, chunk=chunk,
                                     compute_dtype=compute_dtype)
    return ssd_fwd_op(x, dt, A, B, C, D, ssd_config(x, B)["chunk"],
                      name == "bfloat16")


def _unembed_ce_workspace(h: torch.Tensor, table: torch.Tensor, chunk: int,
                          backward: bool) -> torch.Tensor:
    return torch.empty((unembed_ce_workspace_floats(
        h.shape[0], h.shape[1], table.shape[1], h.dtype, chunk,
        backward=backward),), dtype=torch.float32, device=h.device)


class _UnembedCE(torch.autograd.Function):
    """The two operators with their workspaces, allocated here so that the
    step's count and the dry run see them (an operator that takes a
    mutable argument cannot carry ``register_autograd``). The backward is
    the counterpart of ``jax.grad`` through the JAX model's unembedding
    and log-sum-exp."""

    @staticmethod
    def forward(ctx, h, table, labels, chunk):
        ce, lse = unembed_ce_fwd_op(
            h, table, labels, _unembed_ce_workspace(h, table, chunk, False),
            chunk)
        ctx.save_for_backward(h, table, labels, lse)
        ctx.chunk = chunk
        return ce

    @staticmethod
    def backward(ctx, dce):
        h, table, labels, lse = ctx.saved_tensors
        dh, dtable = unembed_ce_bwd_op(
            h, table, labels, lse, dce,
            _unembed_ce_workspace(h, table, ctx.chunk, True), ctx.chunk)
        return dh, dtable, None, None


def unembed_ce_chunked(h: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """The vocab-chunked loss of h [T, d], table [d, V] and labels [T],
    ``chunk`` columns at a time, with autograd: 0-d fp32."""
    return _UnembedCE.apply(h, table, labels, chunk)


def unembed_cross_entropy(h: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """The training loss's unembedding and cross-entropy: h [..., d] (the
    final norm's output), table [d, V] in h's dtype (the compute dtype's
    cast of the fp32 master, or a transposed view of the tied embedding's)
    and labels [...] -> the mean over positions of logsumexp(logits) -
    logits[label], 0-d fp32, the logits h @ table never made whole. The
    vocabulary is walked in chunks of ``vocab_chunk`` columns, a width
    from the shapes alone (``kernels/unembed_ce.py``); on the card the
    chunks run the operator's kernels, on the CPU their plain versions."""
    d = h.shape[-1]
    h = h.reshape(-1, d)
    return unembed_ce_chunked(h, table, labels.reshape(-1),
                      vocab_chunk(h.shape[0], d, table.shape[1], h.dtype))


# The operators' FLOPs, for torch.utils.flop_counter and step_cost: the
# kernels' least work (roofline/kernel_cost.py), 4 d a visible (q, k) pair
# forward and 10 d backward (S recomputed, dV, dP, dK, dQ).

@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_fwd_flops(q, k, v, causal, window, q_offset, *args,
                     **kwargs) -> int:
    b, sq, hq, d = q
    return 4 * d * b * hq * unmasked_pairs(sq, k[1], causal, window, q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q, k, v, lse, do, causal, window, q_offset, *args,
                     **kwargs) -> int:
    b, sq, hq, d = q
    return 10 * d * b * hq * unmasked_pairs(sq, k[1], causal, window,
                                            q_offset)


# The SSD operators' bf16-intra instances do the same least work as the
# default ones (one bf16 part of M and Q is the kernel's arithmetic, not
# the function's), and move the same bytes.
@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _ssd_fwd_flops(x, dt, A, B, C, D, chunk, *args, **kwargs) -> int:
    b, s, h, p = x
    return ssd_flops(b, s, h, p, B[2], B[3], tile=chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _ssd_bwd_flops(x, dt, A, B, C, D, *args, **kwargs) -> int:
    b, s, h, p = x
    return ssd_bwd_flops(b, s, h, p, B[2], B[3])


# The unembedding and cross-entropy's least work (the function's, not the
# chunked operator's recomputation and planes), split by h's dtype.
@register_flop_formula(torch.ops.repro_torch.unembed_ce_fwd)
def _unembed_ce_fwd_flops(h, table, *args, **kwargs) -> int:
    return unembed_ce_flops(h[0], h[1], table[1])


@register_flop_formula(torch.ops.repro_torch.unembed_ce_bwd)
def _unembed_ce_bwd_flops(h, table, *args, **kwargs) -> int:
    return unembed_ce_flops(h[0], h[1], table[1], backward=True)
