#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:
  1. device: versions, the card's name and power limit; TF32 off.
  2. build: every CUDA kernel from src/repro_torch/csrc, with ptxas's
     register and shared-memory report.
  3. kernels: each kernel (flash attention, the SSD scan) against its plain
     PyTorch version at the serving paths' shapes and their edges, then its
     time and achieved TFLOP/s beside the plain version's time, the
     library call's (SDPA; none for SSD) and its bound on the card; for the
     flash backward also the difference between two calls on the same
     inputs (its sums across blocks are atomic) and its kernels' device
     times from torch.profiler.
  4. reference: tiny qwen2.5-3b and tiny mamba2-370m in bf16 on the card
     against the plain CPU path.
  5. serve, once per model: qwen2.5-3b (36 layers) and mamba2-370m (48
     layers), at full width, bf16, random weights from a seed, each answer
     8 requests through ServeEngine; the kernels' launch counts prove the
     prefill ran through its kernel; prefill(S) is held against
     prefill(S-1) + decode_step; torch.profiler splits one prefill and
     four decode steps into device busy and idle time.
  6. reference train: one AdamW step of tiny qwen2.5-3b (bf16 over fp32
     masters) on the card against the plain CPU path: loss, gradient norm
     and every gradient leaf.
  7. train: qwen2.5-3b at full width (fp32 masters, bf16 compute, remat)
     takes 8 AdamW steps on the synthetic stream at B = 2, S = 2048; the
     loss must fall, every step must launch the forward flash kernel 72
     times (36 layers, forward and recompute) and the backward 36 times,
     and peak memory stay under 80 GB; step time, tokens/s, model FLOPs
     utilisation and a torch.profiler split of one step.
The line before the last lists the kernels as JSON; the last line is the
result as JSON. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12   # CUDA cores, outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# A kernel against its plain version in bf16: the largest relative L2
# error of one output row (kernels/ref.py::row_rel_err; an absolute limit
# cannot judge rows whose values range from ~1 to ~0.03). Both sides round
# the output to bf16 (2^-8 relative at most) and the kernel also rounds P
# to bf16 before P @ V, so a sound row errs by a few 1e-3; one wrong key
# among a row's n shifts it by ~1/sqrt(n) of its size, 3e-2 at n = 1024.
KERNEL_ROW_RTOL = 2e-2
# tiny qwen2.5-3b in bf16 on the card against the plain path on the CPU:
# largest relative L2 error of one row of logits. On the CPU the bf16 model
# differs from the same weights in fp32 by <= 7.2e-3 so measured; two bf16
# paths that round in another order differ by about as much, and a wrong
# position, mask or cache slot by a sizeable fraction of 1.
REFERENCE_ROW_RTOL = 3e-2
# prefill(S) against prefill(S-1) + decode_step, relative L2 error of the
# fp32 logits: the two paths round differently in each of 36 bf16 layers
# (2^-8 per rounding; bf16 P in the kernel, fp32 in decode attention); a
# wrong position, mask or cache slot gives an error of order 1.
CONSISTENCY_RTOL = 5e-2
# The SSD kernel against its plain version (the chunked scan at the
# model's chunk of 256): y by the worst row over P, the final state by the
# worst row over N. Both start from the same bf16 inputs; the kernel runs
# its products on bf16 tensor cores with every fp32 operand split into a
# bf16 hi and lo part (~2^-16 relative per term, csrc/ssd.cu's error
# budget), in tiles of 32 instead of chunks of 256. y is then rounded to
# bf16 on both sides (2^-9 relative per element), so a sound row of y errs
# by ~3e-3 at most, and the fp32 state by ~3e-5. A dropped term, a
# position past S, a diagonal off by one or a lost lo part moves whole rows
# by a sizeable fraction of their size or the state past 1e-3.
SSD_Y_ROW_RTOL = 1e-2
SSD_STATE_ROW_RTOL = 1e-3

# The flash backward against its plain version (autograd of the fp32
# reference from the same bf16 inputs): dQ, dK, dV by the worst row's
# relative L2 error, each row's norm raised to at least GRAD_ROW_FLOOR of
# the median row norm (row 0 of dQ is exactly 0 under a causal mask, and
# any rounding of dP - delta is infinitely many times it). The kernel
# rounds P and dS to bf16 before their products (2^-9 relative per term,
# summed with cancellation in dS) and the outputs to bf16 (2^-9), and sums
# delta = rowsum(P o dP) in fp32, so the forward's 2e-2 holds with room: a
# sound kernel errs ~4e-3. SDPA's backward, printed beside it as the
# calibration, takes delta from its bf16 output and errs up to ~0.2 on the
# rows of dQ that cancel (a causal head's row 1, with two keys).
GRAD_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2
# The forward's LSE against the plain logsumexp, absolute: an error e in a
# row's LSE scales that row's P by exp(-e), so 1e-3 admits a 0.1% error in
# P; both sides sum exact products of the same bf16 inputs in fp32.
LSE_ABS_TOL = 1e-3

# One train step of tiny qwen2.5-3b, card against the CPU's plain path,
# both bf16 over the same fp32 masters: each gradient leaf by its worst
# row's relative L2 error (floored as for the kernel's gradients), the loss
# and the gradient norm relatively. The two paths round to bf16 at other
# places in each layer's forward and backward (2^-9 per rounding; the
# logits alone differ by ~1e-2, REFERENCE_ROW_RTOL's measurement), and the
# card's attention gradients carry the kernel's own roundings; a wrong
# mask, head or missing term moves whole rows by a sizeable fraction.
TRAIN_GRAD_ROW_RTOL = 5e-2
TRAIN_LOSS_RTOL = 1e-2

QWEN, MAMBA = "qwen2.5-3b", "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 8, 3e-4
CARD_BYTES = 80e9
BATCH, CACHE_LEN, NEW_TOKENS = 8, 2048, 32
PROMPT_LENS = (256, 1024)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    say(phase, "FAIL " + msg)
    raise SystemExit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_flops(b: int, hq: int, s: int, d: int) -> int:
    """Causal attention's work: 4*d FLOPs per unmasked (q, k) pair."""
    return 4 * d * (s * (s + 1) // 2) * b * hq


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs one head attends: k < Sk, k <= q if causal, k > q -
    window if windowed."""
    import numpy as np
    r = np.arange(sq)
    hi = np.minimum(r, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_bwd_bound(b: int, hq: int, hkv: int, s: int, d: int,
                        pairs: int) -> tuple[float, str]:
    """Least time (ms) for the attention backward: 10*d FLOPs per unmasked
    pair (S recomputed, dV, dP, dK, dQ) over the bf16 peak, or one read of
    q, k, v, dO and the fp32 LSE and one write of dq, dk, dv over the
    memory rate; and which of the two sets it."""
    ops_ms = 1e3 * 10 * d * pairs * b * hq / PEAK_BF16_FLOPS
    nbytes = 2 * b * s * d * (3 * hq + 4 * hkv) + 4 * b * hq * s
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def attention_bound(b: int, hq: int, hkv: int, s: int,
                    d: int) -> tuple[float, str]:
    """Least time (ms) for causal attention on these shapes, and what sets
    it: its FLOPs over the bf16 peak, or one read of q, k, v and one write
    of o over the memory rate."""
    ops_ms = 1e3 * attention_flops(b, hq, s, d) / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * 2 * b * s * d * (2 * hq + 2 * hkv) / PEAK_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def ssd_flops(b: int, s: int, h: int, p: int, g: int, n: int) -> int:
    """The SSD scan's least work at the kernel's tile L: per (batch, group,
    tile) the lower triangle of C . B^T, 2 N FLOPs per (i >= j) pair; per
    (batch, head, tile) the triangle of M @ x, 2 P per pair; per token and
    head the inter-chunk term and the state update, 2 N P each. Decays and
    dt weights are O(S H) and left out."""
    from repro_torch.kernels.ssd import TILE
    tiles = -(-s // TILE)
    pairs = TILE * (TILE + 1) // 2
    return (b * g * tiles * pairs * 2 * n + b * h * tiles * pairs * 2 * p
            + b * h * s * 4 * n * p)


def ssd_bound(b: int, s: int, h: int, p: int, g: int, n: int, *,
              peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the SSD scan on these shapes at ``peak_flops``
    (the kernel's products run on bf16 tensor cores), and what sets it:
    ``ssd_flops``, or one read of x, dt, B, C and one write of y (bf16
    except dt) and of the fp32 final state."""
    nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * g * n
              + 4 * b * h * p * n)
    ops_ms = 1e3 * ssd_flops(b, s, h, p, g, n) / peak_flops
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s); "
        "TF32 off for matmul and cuDNN")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    say("build", f"{lib.path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            say("build", line.strip())


def phase_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference, row_rel_err

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, s, hq, hkv, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for h in (hq, hkv, hkv)]

    # (name, B, S, Hq, Hkv, D, window, causal): the serving path's prefill
    # shape first (8 prompts padded to 1024, qwen2.5-3b heads), then its
    # variants; non-causal at S = 1000, where only the `kpos < Sk` mask
    # hides the zero keys past Sk in the last 128-key tile
    cases = [("main", BATCH, PROMPT_LENS[1], 16, 2, 128, 0, True),
             ("ragged", BATCH, 1000, 16, 2, 128, 0, True),
             ("window", BATCH, 1024, 16, 2, 128, 256, True),
             ("d64", 4, 512, 8, 2, 64, 0, True),
             ("noncausal", 2, 1000, 16, 2, 128, 0, False)]
    worst, failed = 0.0, []
    for name, b, s, hq, hkv, d, window, causal in cases:
        q, k, v = qkv(b, s, hq, hkv, d)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                                  causal=causal, window=window).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        row = row_rel_err(out, ref)
        worst = max(worst, err)
        ok = math.isfinite(row) and row <= KERNEL_ROW_RTOL
        if not ok:
            failed.append(name)
        say("kernels", f"flash_attention {name} B={b} S={s} Hq={hq} Hkv={hkv}"
            f" D={d} window={window} causal={causal}: worst row rel L2 err "
            f"{row:.3e} (tol "
            f"{KERNEL_ROW_RTOL}), all rel L2 {rel:.3e}, max abs err "
            f"{err:.3e}, mean |ref| {ref.float().abs().mean().item():.3e} "
            f"{'ok' if ok else 'FAIL'}")
    if failed:
        fail("kernels", f"flash_attention disagrees with plain: {failed}")

    _, b, s, hq, hkv, d, _, _ = cases[0]
    q, k, v = qkv(b, s, hq, hkv, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=50)
    lse_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                             return_lse=True), iters=50)
    plain_ms = cuda_ms(lambda: attention_reference(qt, kt, vt, causal=True),
                       iters=5, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=50)
    bound_ms, bound_by = attention_bound(b, hq, hkv, s, d)
    tflops = attention_flops(b, hq, s, d) / ms / 1e9
    say("kernels", f"flash_attention main: {ms:.4f} ms ({tflops:.1f} TFLOP/s"
        f"), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"({library_ms / ms:.3f}x the kernel's speed), bound {bound_ms:.4f} "
        f"ms ({bound_by}, {100 * bound_ms / ms:.1f}% reached); with the "
        f"LSE written (training) {lse_ms:.4f} ms, on {card}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_flash_bwd_kernels(card: str) -> dict:
    """The backward kernel and the forward's LSE against their plain
    versions at the training path's shape and its edges; the backward's
    time beside the plain version's, SDPA's backward and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         attention_lse_reference, row_rel_err)

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(b, s, h, d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def heads_first(*ts):
        return [t.transpose(1, 2) for t in ts]

    def sdpa(q, k, v, causal, window):
        """SDPA in its layout on leaves that require grad, as the
        library's yardstick: (inputs, output)."""
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if window:
            r = torch.arange(q.shape[1], device="cuda")[:, None]
            c = torch.arange(k.shape[1], device="cuda")[None, :]
            mask = (c > r - window) & ((r >= c) if causal else True)
        out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and not window,
            enable_gqa=True)
        return (qs, ks, vs), out

    # (name, B, S, Hq, Hkv, D, window, causal): the training shape first
    # (qwen2.5-3b's heads at B = 2, S = 2048), then its edges
    cases = [("train", TRAIN_BATCH, TRAIN_SEQ, 16, 2, 128, 0, True),
             ("ragged", 2, 1000, 16, 2, 128, 0, True),
             ("window", 2, 2048, 16, 2, 128, 256, True),
             ("d64", 2, 512, 8, 2, 64, 0, True),
             ("noncausal", 2, 1000, 16, 2, 128, 0, False),
             ("group1", 2, 512, 4, 4, 128, 0, True)]
    worst, failed = 0.0, []
    for name, b, s, hq, hkv, d, window, causal in cases:
        q, k, v, do = (randn(b, s, h, d) for h in (hq, hkv, hkv, hq))
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        same = torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                window=window))
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        _, lse_ref = attention_lse_reference(*heads_first(q, k, v),
                                             causal=causal, window=window)
        lse_err = (lse - lse_ref).abs().max().item()
        refs = [t.transpose(1, 2) for t in attention_backward_reference(
            *heads_first(q, k, v, do), causal=causal, window=window)]
        errs = [row_rel_err(x, r, floor=GRAD_ROW_FLOOR)
                for x, r in zip((dq, dk, dv), refs)]
        leaves, o_lib = sdpa(q, k, v, causal, window)
        lib = torch.autograd.grad(o_lib, leaves, do.transpose(1, 2))
        lib_errs = [row_rel_err(x.transpose(1, 2), r, floor=GRAD_ROW_FLOOR)
                    for x, r in zip(lib, refs)]
        worst = max([worst] + [(x.float() - r).abs().max().item()
                               for x, r in zip((dq, dk, dv), refs)])
        ok = (same and math.isfinite(lse_err) and lse_err <= LSE_ABS_TOL
              and all(math.isfinite(e) and e <= GRAD_ROW_RTOL for e in errs))
        if not ok:
            failed.append(name)
        say("kernels", f"flash_bwd {name} B={b} S={s} Hq={hq} Hkv={hkv} D={d}"
            f" window={window} causal={causal}: dq/dk/dv worst row rel L2 "
            f"err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
            f"{GRAD_ROW_RTOL}, floor {GRAD_ROW_FLOOR} x median), SDPA's "
            f"{lib_errs[0]:.3e}/{lib_errs[1]:.3e}/{lib_errs[2]:.3e}; lse max "
            f"abs err {lse_err:.3e} (tol {LSE_ABS_TOL}); forward output with "
            f"the LSE bit-equal to without: {same} {'ok' if ok else 'FAIL'}")
    if failed:
        fail("kernels", f"flash_attention_bwd disagrees with plain: {failed}")

    _, b, s, hq, hkv, d, window, causal = cases[0]
    q, k, v, do = (randn(b, s, h, d) for h in (hq, hkv, hkv, hq))
    _, lse = flash_attention(q, k, v, return_lse=True)
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, lse, do), iters=20)
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True),
                     iters=20)
    plain_ms = cuda_ms(lambda: attention_backward_reference(
        *heads_first(q, k, v, do)), iters=3, warmup=1)
    leaves, o_lib = sdpa(q, k, v, causal, window)
    do_t = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o_lib, leaves, do_t, retain_graph=True), iters=20)
    pairs = unmasked_pairs(s, s, causal, window)
    bound_ms, bound_by = attention_bwd_bound(b, hq, hkv, s, d, pairs)
    tflops = 10 * d * pairs * b * hq / ms / 1e9
    say("kernels", f"flash_attention_bwd train: {ms:.4f} ms ({tflops:.1f} "
        f"TFLOP/s at 10*D per pair), plain {plain_ms:.4f} ms, SDPA backward "
        f"{library_ms:.4f} ms ({library_ms / ms:.3f}x the kernel's speed), "
        f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% "
        f"reached); forward with the LSE at this shape {fwd_ms:.4f} ms, on "
        f"{card}")
    # The kernels sum dQ, dK and dV across blocks by fp32 atomic adds, in the
    # order the blocks finish: two calls on the same inputs, compared.
    first, second = (flash_attention_bwd(q, k, v, lse, do) for _ in range(2))
    torch.cuda.synchronize()
    runs = [row_rel_err(x, y, floor=GRAD_ROW_FLOOR)
            for x, y in zip(first, second)]
    equal = [torch.equal(x, y) for x, y in zip(first, second)]
    say("kernels", f"flash_attention_bwd train run to run: dq/dk/dv worst row "
        f"rel L2 difference {runs[0]:.3e}/{runs[1]:.3e}/{runs[2]:.3e} (floor "
        f"{GRAD_ROW_FLOOR} x median), bit-equal {equal[0]}/{equal[1]}/"
        f"{equal[2]}")
    profile_window("flash_bwd train", lambda: flash_attention_bwd(
        q, k, v, lse, do), card, share_of="flash_bwd")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:51",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def ssd_inputs(gen, b: int, s: int, h: int, p: int, g: int, n: int):
    """The JAX kernel tests' distributions: x ~ N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(U[0, 1]), B/C ~ N(0, 1/4), D = 1; x, B, C
    in bf16, the rest fp32, on the card."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, s, h, p).bfloat16()
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
    B = (randn(b, s, g, n) * 0.5).bfloat16()
    C = (randn(b, s, g, n) * 0.5).bfloat16()
    D = torch.ones((h,), device="cuda")
    return x, dt, A, B, C, D


def phase_ssd_kernels(card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import row_rel_err, ssd_chunked_reference
    from repro_torch.kernels.ssd import ssd_chunked_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    scfg = get_config(MAMBA).ssm
    chunk = scfg.chunk_size
    heads = scfg.expand * get_config(MAMBA).d_model // scfg.head_dim
    # (name, B, S, H, P, G, N): the serving path's prefill shape first (8
    # prompts padded to 1024, mamba2-370m's heads and state), then its
    # variants (S one position into a second tile) and tiny mamba2-370m's
    # shape
    cases = [("main", BATCH, PROMPT_LENS[1], heads, scfg.head_dim, 1,
              scfg.state_dim),
             ("ragged", BATCH, 1000, heads, scfg.head_dim, 1, scfg.state_dim),
             ("s65", 2, 65, heads, scfg.head_dim, 1, scfg.state_dim),
             ("grouped", 2, 512, 8, 64, 2, 64),
             ("tiny", 2, 100, 16, 32, 1, 16)]
    worst, failed = 0.0, []
    for name, b, s, h, p, g, n in cases:
        args = ssd_inputs(gen, b, s, h, p, g, n)
        y, st = ssd_chunked_kernel(*args)
        torch.cuda.synchronize()
        y_ref, st_ref = ssd_chunked_reference(*args, chunk=chunk)
        y_row, st_row = row_rel_err(y, y_ref), row_rel_err(st, st_ref)
        err = (y.float() - y_ref.float()).abs().max().item()
        st_err = (st - st_ref).abs().max().item()
        worst = max(worst, err)
        ok = (math.isfinite(y_row) and y_row <= SSD_Y_ROW_RTOL
              and math.isfinite(st_row) and st_row <= SSD_STATE_ROW_RTOL)
        if not ok:
            failed.append(name)
        say("kernels", f"ssd {name} B={b} S={s} H={h} P={p} G={g} N={n}: "
            f"y worst row rel L2 err {y_row:.3e} (tol {SSD_Y_ROW_RTOL}), "
            f"max abs {err:.3e}; final_state worst row {st_row:.3e} (tol "
            f"{SSD_STATE_ROW_RTOL}), max abs {st_err:.3e}, max |state| "
            f"{st_ref.abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
    if failed:
        fail("kernels", f"ssd disagrees with plain: {failed}")

    _, b, s, h, p, g, n = cases[0]
    args = ssd_inputs(gen, b, s, h, p, g, n)
    ms = cuda_ms(lambda: ssd_chunked_kernel(*args), iters=20)
    plain_ms = cuda_ms(lambda: ssd_chunked_reference(*args, chunk=chunk),
                       iters=5, warmup=1)
    bound_ms, bound_by = ssd_bound(b, s, h, p, g, n)
    fp32_ms, fp32_by = ssd_bound(b, s, h, p, g, n, peak_flops=PEAK_FP32_FLOPS)
    tflops = ssd_flops(b, s, h, p, g, n) / ms / 1e9
    say("kernels", f"ssd main: {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, no library call, bound {bound_ms:.4f} ms "
        f"({bound_by}, bf16 tensor cores, the kernel's arithmetic; "
        f"{100 * bound_ms / ms:.1f}% reached), fp32 CUDA-core bound "
        f"{fp32_ms:.4f} ms ({fp32_by}) on {card}")
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:27", "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def launch_counters() -> dict:
    """Every kernel wrapper, by the name the kernels line gives it."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd import ssd_chunked_kernel
    return {"flash_attention": flash_attention, "ssd": ssd_chunked_kernel,
            "flash_attention_bwd": flash_attention_bwd}


def phase_serve(card: str, arch: str, kernel: str) -> int:
    """Serves ``arch`` at full width; returns ``kernel``'s launch count
    over the main path, which must be one prefill's, one per layer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    say("serve", f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{model.count_params() / 1e9:.3f} B params in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(model, params, batch=BATCH, cache_len=CACHE_LEN,
                         device="cuda")

    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, BATCH)
    lens[0] = PROMPT_LENS[1]  # the batch pads to the kernel check's shape
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def make_requests(new_tokens):
        return [Request(prompt=p, max_new_tokens=new_tokens,
                        temperature=0.7 if i % 2 else 0.0)
                for i, p in enumerate(prompts)]

    # warm-up at the same shapes (cuBLAS heuristics, allocator), not counted
    engine.generate(make_requests(2), seed=0)
    requests = make_requests(NEW_TOKENS)

    # every logit the engine samples from is checked after the run
    finite = []
    entry_points = model.prefill, model.decode_step

    def watch(fn):
        def watched(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return watched

    model.prefill, model.decode_step = map(watch, entry_points)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine.generate(requests, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model.prefill, model.decode_step = entry_points

    # one prefill for the batch, one launch per layer; no other kernel
    want = {name: cfg.num_layers if name == kernel else 0
            for name in counters}
    if counts != want:
        fail("serve", f"{arch}: kernel launches {counts}, expected {want} "
             f"({cfg.num_layers} layers x 1 prefill)")
    launches = counts[kernel]
    if len(finite) != 1 + NEW_TOKENS or not all(bool(f) for f in finite):
        fail("serve", f"non-finite logits in the main path ({len(finite)} "
             "calls watched)")
    n_tok = sum(len(r.generated) for r in requests)
    bad = [t for r in requests for t in r.generated
           if not 0 <= t < cfg.vocab_size]
    if n_tok != BATCH * NEW_TOKENS or bad:
        fail("serve", f"{n_tok} tokens generated, out of range: {bad[:8]}")
    say("serve", f"{arch} generate: {BATCH} requests, prompts {lens.min()}-"
        f"{lens.max()}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, peak memory {peak_gb:.2f} GB, "
        f"{kernel} launches {launches}, logits of all {len(finite)} "
        f"prefill/decode calls finite, on {card}")

    # The same batch again through the model's entry points, timed apart.
    plen = int(lens.max())
    toks = np.zeros((BATCH, plen), np.int32)
    for i, r in enumerate(requests):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    unembed = engine.unembed
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: model.prefill(
            params, {"tokens": toks}, cache_len=CACHE_LEN, unembed=unembed),
            iters=3, warmup=1)
        logits, cache = model.prefill(params, {"tokens": toks},
                                      cache_len=CACHE_LEN, unembed=unembed)
        all_finite = bool(torch.isfinite(logits).all())
        nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = model.decode_step(params, nxt, cache, plen + step,
                                              unembed=unembed)
            all_finite &= bool(torch.isfinite(logits).all())
            nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / NEW_TOKENS
    if not all_finite:
        fail("serve", "non-finite logits")
    say("serve", f"{arch} prefill B={BATCH} S={plen}: {prefill_ms:.2f} ms; decode: "
        f"{decode_ms:.2f} ms/step ({BATCH * 1e3 / decode_ms:.1f} tok/s); "
        f"all logits finite, on {card}")

    # prefill(S) == prefill(S-1) + decode_step(token S-1)
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks}, cache_len=CACHE_LEN,
                                unembed=unembed)
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                 cache_len=CACHE_LEN, unembed=unembed)
        step, _ = model.decode_step(params, toks[:, -1:], cache, plen - 1,
                                    unembed=unembed)
    rel = ((step - full).norm() / full.norm()).item()
    max_abs = (step - full).abs().max().item()
    ok = math.isfinite(rel) and rel <= CONSISTENCY_RTOL
    say("serve", f"{arch} prefill(S) vs prefill(S-1)+decode: relative L2 {rel:.3e} "
        f"(tol {CONSISTENCY_RTOL}), max abs {max_abs:.3e}, max |logit| "
        f"{full.abs().max().item():.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("serve", "prefill and decode disagree")

    for name, fn in (
            ("prefill", lambda: model.prefill(params, {"tokens": toks},
                                              cache_len=CACHE_LEN,
                                              unembed=unembed)),
            ("decode x4", lambda: [model.decode_step(params, toks[:, -1:],
                                                     cache, plen + i,
                                                     unembed=unembed)
                                   for i in range(4)])):
        profile_window(f"{arch} {name}", fn, card)
    return launches


def profile_window(name: str, fn, card: str, *, grad: bool = False,
                   share_of: str | None = None, top: int = 6) -> None:
    """Device busy share and the ``top`` kernels of one call, from
    torch.profiler: kernel time summed over the window's wall time; with
    ``share_of``, also the share of the kernels whose name holds it, and
    each of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.set_grad_enabled(grad), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only: host ops also carry their kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    say("profile", f"{name}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), idle "
        f"{100 * (1 - busy_us / wall_us):.1f}%, {sum(r[1] for r in rows)} "
        f"kernels, on {card} (profiler on)")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        say("profile", f"  {name}: {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}%"
            f" x{count} {key[:90]}")
    if share_of and busy_us:
        mine = [r for r in rows if share_of in r[2]]
        us = sum(r[0] for r in mine)
        say("profile", f"  {name}: kernels named *{share_of}*: {us / 1e3:.3f} "
            f"ms, {100 * us / busy_us:.1f}% of device busy, "
            f"x{sum(r[1] for r in mine)}")
        for us, count, key in sorted(mine, reverse=True):
            say("profile", f"  {name}: *{share_of}* {us / 1e3:8.3f} ms x{count} "
                f"{key[:90]}")


def phase_small_reference(card: str, arch: str) -> None:
    """The card against the plain CPU path (which the CPU tests hold
    against the JAX package) on tiny ``arch`` in bf16, same weights:
    prefill and three decode steps, to REFERENCE_ROW_RTOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_tiny
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models.model import Model

    cfg = get_tiny(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = {k: ({n: t.cuda() for n, t in v.items()} if k == "layers"
                 else v.cuda()) for k, v in p_cpu.items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 100)).astype(np.int32))
    worst = 0.0
    with torch.no_grad():
        lc, cc = cpu.prefill(p_cpu, {"tokens": toks}, cache_len=128)
        lg, cg = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, cache_len=128)
        worst = max(worst, row_rel_err(lg.cpu(), lc))
        for i in range(3):
            nxt = lc.argmax(-1, keepdim=True)
            lc, cc = cpu.decode_step(p_cpu, nxt, cc, 100 + i)
            lg, cg = gpu.decode_step(p_gpu, nxt.cuda(), cg, 100 + i)
            worst = max(worst, row_rel_err(lg.cpu(), lc))
    ok = math.isfinite(worst) and worst <= REFERENCE_ROW_RTOL
    say("reference", f"tiny {arch} bf16, card vs CPU plain path: prefill + 3 "
        f"decode steps, worst row rel L2 logit err {worst:.3e} (tol "
        f"{REFERENCE_ROW_RTOL}) {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail("reference", "the card disagrees with the CPU path")


def phase_small_train_reference(card: str) -> None:
    """One train step of tiny qwen2.5-3b, bf16 over fp32 masters, on the
    card against the plain CPU path (which the CPU tests hold against the
    JAX package's train step): the loss, the gradient norm and each
    gradient leaf. The parameters after the step are not compared: Adam's
    first step is ~lr * sign(g), which bf16 noise in a near-zero gradient
    flips."""
    import torch
    from repro_torch.configs import get_tiny
    from repro_torch.data.loader import Loader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init, tree_leaves,
                                         tree_map)
    from repro_torch.train.step import loss_and_grads, make_train_step

    cfg = get_tiny(QWEN)
    models = {"cpu": Model(cfg, device="cpu"), "cuda": Model(cfg, device="cuda")}
    p_cpu = models["cpu"].init(torch.Generator().manual_seed(0),
                               dtype=torch.float32)
    stream = SyntheticStream(cfg.vocab_size, 0)
    out = {}
    for dev, model in models.items():
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        batch = Loader(stream, 4, 128, dev)(0)
        grads = tree_map(torch.zeros_like, params)
        loss_and_grads(model, params, batch, grads)
        _, _, metrics = make_train_step(model, AdamWConfig())(
            params, adamw_init(params), batch)
        out[dev] = (grads, {k: float(v) for k, v in metrics.items()})
    (g_cpu, m_cpu), (g_gpu, m_gpu) = out["cpu"], out["cuda"]
    worst, where = 0.0, ""
    names = [f"{k}/{n}" if isinstance(v, dict) else k
             for k, v in sorted(g_cpu.items())
             for n in (sorted(v) if isinstance(v, dict) else [None])]
    for name, ref, got in zip(names, tree_leaves(g_cpu), tree_leaves(g_gpu)):
        err = row_rel_err(got.cpu(), ref, floor=GRAD_ROW_FLOOR)
        if not err <= worst:
            worst, where = err, name
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    ok = (math.isfinite(worst) and worst <= TRAIN_GRAD_ROW_RTOL
          and all(r <= TRAIN_LOSS_RTOL for r in rel.values()))
    say("reference", f"tiny {QWEN} train step, bf16 over fp32 masters, card "
        f"vs CPU plain path: loss {m_gpu['loss']:.5f} vs {m_cpu['loss']:.5f}"
        f" (rel {rel['loss']:.2e}), grad_norm {m_gpu['grad_norm']:.5f} vs "
        f"{m_cpu['grad_norm']:.5f} (rel {rel['grad_norm']:.2e}; tol "
        f"{TRAIN_LOSS_RTOL}); worst gradient row rel L2 err {worst:.3e} in "
        f"{where} (tol {TRAIN_GRAD_ROW_RTOL}) {'ok' if ok else 'FAIL'} on "
        f"{card}")
    if not ok:
        fail("reference", "the card's train step disagrees with the CPU path")


def phase_train(card: str) -> int:
    """qwen2.5-3b at full width takes TRAIN_STEPS AdamW steps; returns the
    backward kernel's launches over the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.loader import Loader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(QWEN)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    params, opt = state.params, state.opt
    torch.cuda.synchronize()
    n_params = model.count_params()
    say("train", f"{QWEN}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, fp32 masters + AdamW mu/nu "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, compute {cfg.dtype}, "
        f"remat {model.remat}; init {time.perf_counter() - t0:.1f} s")
    loader = Loader(SyntheticStream(cfg.vocab_size, 0), TRAIN_BATCH, TRAIN_SEQ,
                    "cuda")
    step_fn = make_train_step(model, AdamWConfig(lr=TRAIN_LR))
    counters = launch_counters()
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers, "ssd": 0}
    losses, gnorms, times, total = [], [], [], dict.fromkeys(counters, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        batch = loader(step)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {name: fn.launches for name, fn in counters.items()}
        if counts != want:
            fail("train", f"step {step}: kernel launches {counts}, expected "
                 f"{want} ({cfg.num_layers} layers: forward + remat "
                 "recompute, backward)")
        for name, n in counts.items():
            total[name] += n
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        say("train", f"step {step}: loss {losses[-1]:.4f}, grad_norm "
            f"{gnorms[-1]:.3f}, {1e3 * times[-1]:.1f} ms, launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("train", f"non-finite loss or gradient norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail("train", f"loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not peak < CARD_BYTES:
        fail("train", f"peak memory {peak / 1e9:.2f} GB exceeds the card's 80 GB")
    step_s = statistics.median(times[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = n_params - cfg.vocab_size * cfg.d_model  # all but the embedding
    attn = 3.5 * cfg.num_layers * attention_flops(
        TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.head_dim)
    flops = 6 * n_matmul * tokens + attn
    say("train", f"{TRAIN_STEPS} steps B={TRAIN_BATCH} S={TRAIN_SEQ}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step (steps 3-"
        f"{TRAIN_STEPS}) {1e3 * step_s:.1f} ms (all: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}), {tokens / step_s:.0f}"
        f" tokens/s, model FLOPs {flops / 1e12:.1f} T per step (6 N T, N = "
        f"{n_matmul / 1e9:.3f} B outside the embedding, + attention "
        f"{attn / 1e12:.2f} T; remat's recompute not counted) = "
        f"{100 * flops / step_s / PEAK_BF16_FLOPS:.1f}% MFU of 989 TFLOP/s; "
        f"peak memory {peak / 1e9:.2f} GB; launches over the run {total}, on "
        f"{card}")
    profile_window(f"{QWEN} train step", lambda: step_fn(params, opt,
                                                         loader(TRAIN_STEPS)),
                   card, grad=True, share_of="flash_bwd", top=14)
    return total["flash_attention_bwd"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    flash, ssd = phase_kernels(card), phase_ssd_kernels(card)
    flash_bwd = phase_flash_bwd_kernels(card)
    phase_small_reference(card, QWEN)
    phase_small_reference(card, MAMBA)
    flash["launches"] = phase_serve(card, QWEN, "flash_attention")
    ssd["launches"] = phase_serve(card, MAMBA, "ssd")
    phase_small_train_reference(card)
    flash_bwd["launches"] = phase_train(card)
    print(json.dumps({"kernels": [flash, ssd, flash_bwd]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
