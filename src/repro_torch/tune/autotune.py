"""The autotune loop: sweep launch configs, prune with the H100 roofline,
verify against the plain versions, record winners. A port of the JAX
package's ``tune/autotune.py``.

Sweep shape per kernel:

  1. enumerate candidate configs. On the card (any backend but
     ``CPU_BACKEND``) these are the template instances compiled into the
     kernel library (``CONFIGS`` of ``kernels/flash_attention.py`` and
     ``kernels/ssd.py``) whose tiles fit the shape's bucket; on the CPU
     the JAX package's grid (``CANDIDATE_BLOCKS``, ``CANDIDATE_CHUNKS``)
     clamped to the sequence, run through the plain versions that take
     the same knobs (``chunked_attention``'s ``q_chunk``/``k_chunk``,
     ``ssd_chunked_reference``'s ``chunk``). The default config is always
     a candidate, so a winner can never be *worse* than the default under
     the same measurement;
  2. price every candidate with the roofline (``repro_torch.tune.prune``);
     only the best few reach measurement;
  3. run each survivor once and hold it to the plain version by the worst
     row's relative L2 error (``row_rel_err``, ``ROW_RTOL``): a config
     that fails is discarded no matter how fast it is;
  4. measure the survivors back-to-back on the process-wide measurement
     pool (ONE worker thread: concurrent tuning jobs would contend for the
     card and corrupt each other's timings): on the card with CUDA events
     after a warm-up, best of ``repeats`` rounds of ``INNER`` calls; on
     the CPU by the host clock; and record the argmin.

``stats["tune_invocations"]`` counts sweeps — the warm-boot acceptance
counter: a profile-cache hit must leave it untouched.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ssd
from repro_torch.kernels.ops import DEFAULT_ATTENTION as DEFAULT_CARD_ATTENTION
from repro_torch.kernels.ops import DEFAULT_SSD as DEFAULT_CARD_SSD
from repro_torch.kernels.ops import card_backend
from repro_torch.kernels.ref import (attention_reference, row_rel_err,
                                     ssd_chunked_reference)
from repro_torch.models.attention import chunked_attention
from repro_torch.models.ssm import ssd_reference
from repro_torch.tune import prune
from repro_torch.tune.profile import (TuningProfile, attention_key,
                                      shape_bucket, ssd_key)

# module-wide counters (process lifetime); tune_invocations is the
# zero-re-tuning witness asserted by StartupResult.notes
stats = {"tune_invocations": 0, "measurements": 0, "pruned": 0,
         "verify_failures": 0}

# the backend whose sweeps run the plain versions on CPU tensors
CPU_BACKEND = "cpu"
CANDIDATE_BLOCKS = (32, 64, 128, 256)
CANDIDATE_CHUNKS = (32, 64, 128, 256)
# the plain versions' defaults on the CPU (the JAX package's); on the card
# the kernels' (DEFAULT_CARD_*, kernels/ops.py's)
DEFAULT_ATTENTION = {"block_q": 128, "block_k": 128}
DEFAULT_SSD = {"chunk": 256}

# a candidate against the plain version: the worst row's relative L2
# error of every output (kernels/ref.py::row_rel_err). In bf16 both sides
# round the output (2^-9) and the kernels round P or their split operands,
# a few 1e-3 in a sound row (chip_smoke.py's gates); in fp32 the plain
# versions differ from the reference by their order of summation alone
ROW_RTOL = {"float32": 1e-3, "bfloat16": 2e-2}
# calls timed between two CUDA events
INNER = 10

MEASURE_TIMEOUT_S = 300.0

# ---------------------------------------------------------------------------
# the measurement pool: a process-wide singleton.  Per-sweep executors
# would pay thread-spawn per tune AND let two sweeps time concurrently.
# ---------------------------------------------------------------------------

_pool = None
_pool_lock = threading.Lock()


def _measure_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                1, thread_name_prefix="tune-measure")
        return _pool


def _measure(thunk, repeats: int, on_card: bool) -> float:
    """Best-of-``repeats`` seconds a call of ``thunk`` on the measurement
    pool, after one warm-up call: on the card the CUDA events' time of
    ``INNER`` calls over ``INNER``, on the CPU the host clock's of one."""
    stats["measurements"] += 1

    def job():
        thunk()
        best = float("inf")
        for _ in range(max(1, repeats)):
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(INNER):
                    thunk()
                end.record()
                torch.cuda.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3 / INNER)
            else:
                t0 = time.perf_counter()
                thunk()
                best = min(best, time.perf_counter() - t0)
        return best

    return _measure_pool().submit(job).result(timeout=MEASURE_TIMEOUT_S)


def _sweep(kernel: str, key: str, candidates: list, default: dict,
           make_thunk, check, predict, repeats: int, prune_keep: int,
           profile, on_card: bool):
    """Shared sweep body: prune -> verify -> measure -> record."""
    stats["tune_invocations"] += 1
    priced = prune.prune_candidates(candidates, predict, keep=prune_keep)
    # the default config must survive pruning: the winner is only
    # meaningful relative to a default measured under identical load
    if default not in [cfg for cfg, _ in priced]:
        priced.append((default, float("inf")))
    stats["pruned"] += max(0, len(candidates) - len(priced))

    measured = {}
    predicted = dict((tuple(sorted(c.items())), p) for c, p in priced)
    for cfg, _pred in priced:
        thunk = make_thunk(cfg)
        try:
            ok = check(thunk())
        except (ValueError, RuntimeError):  # a config the kernel refuses
            ok = False
        if not ok:
            stats["verify_failures"] += 1
            continue
        measured[tuple(sorted(cfg.items()))] = _measure(thunk, repeats,
                                                        on_card)
    if not measured:
        raise RuntimeError(
            f"autotune: no {kernel} candidate passed verification "
            f"for {key}")
    win = min(measured, key=measured.get)
    config = dict(win)
    pred_win = predicted.get(win)
    if pred_win is not None and pred_win == float("inf"):
        pred_win = None  # keep the profile JSON strictly finite
    entry = {"config": config, "measured_s": measured[win],
             "predicted_s": pred_win,
             "default_s": measured.get(tuple(sorted(default.items()))),
             "candidates": len(candidates), "measured": len(measured)}
    if profile is not None:
        rec = profile.record(key, config,
                             measured_s=entry["measured_s"],
                             predicted_s=entry["predicted_s"])
        rec.update({k: v for k, v in entry.items() if k not in rec})
    return key, entry


def _within_rtol(dtype: str, *pairs) -> bool:
    return all(row_rel_err(out, ref) <= ROW_RTOL[dtype] for out, ref in pairs)


# ---------------------------------------------------------------------------
# per-kernel sweeps
# ---------------------------------------------------------------------------


def attention_candidates(sq: int, sk: int, *, head_dim: int | None = None
                         ) -> list:
    """The CPU's grid of (block_q, block_k), each clamped to the sequence
    (the JAX package's); with ``head_dim``, the card's compiled instances
    at that head dim whose tiles fit the lengths' buckets (the kernel
    masks a ragged tile, so nothing is clamped)."""
    if head_dim is not None:
        return [{"block_q": bq, "block_k": bk}
                for bq, bk in flash.CONFIGS[head_dim]
                if bq <= shape_bucket(sq) and bk <= shape_bucket(sk)]
    seen, out = set(), []
    for bq in CANDIDATE_BLOCKS:
        for bk in CANDIDATE_BLOCKS:
            cfg = (min(bq, sq), min(bk, sk))
            if cfg not in seen:
                seen.add(cfg)
                out.append({"block_q": cfg[0], "block_k": cfg[1]})
    return out


def ssd_candidates(s: int, *, state_dim: int | None = None) -> list:
    """The CPU's chunks clamped to the sequence (the JAX package's); with
    ``state_dim``, the card's compiled tiles at that state dim that fit
    the sequence's bucket."""
    if state_dim is not None:
        return [{"chunk": c} for c in ssd.CONFIGS[state_dim]
                if c <= shape_bucket(s)]
    seen, out = set(), []
    for ch in CANDIDATE_CHUNKS:
        c = min(ch, s)
        if c not in seen:
            seen.add(c)
            out.append({"chunk": c})
    return out


def _setting(backend: str, dtype: str | None):
    """(on the card, device, dtype name, torch dtype) of a sweep: bf16 on
    the card, whose kernels take nothing else; fp32 on the CPU."""
    on_card = backend != CPU_BACKEND
    dtype = dtype or ("bfloat16" if on_card else "float32")
    return on_card, "cuda" if on_card else "cpu", dtype, getattr(torch, dtype)


def tune_attention(*, b: int = 1, hq: int = 4, hkv: int = 2,
                   sq: int = 128, sk: int | None = None, d: int = 64,
                   dtype: str | None = None, causal: bool = True,
                   window: int = 0, backend: str | None = None,
                   repeats: int = 3, prune_keep: int = 4, profile=None,
                   seed: int = 0):
    """Sweep the flash forward's block shapes for one workload; returns
    ``(key, entry)`` and records into ``profile`` when given. ``backend``
    None is the card's (``card_backend()``); ``CPU_BACKEND`` sweeps the
    plain version (``chunked_attention``), which is causal only."""
    backend = card_backend() if backend is None else backend
    on_card, device, dtype, tdt = _setting(backend, dtype)
    sk = sq if sk is None else sk
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device)
               .to(tdt) for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=causal, window=window).transpose(1, 2)
    key = attention_key(sq=sq, sk=sk, d=d, g=hq // hkv, dtype=dtype,
                        causal=causal, window=window, backend=backend)
    if on_card:
        candidates = attention_candidates(sq, sk, head_dim=d)
        default = dict(DEFAULT_CARD_ATTENTION)

        def make_thunk(cfg):
            return functools.partial(flash.flash_attention, q, k, v,
                                     causal=causal, window=window, **cfg)
    else:
        if not causal:
            raise ValueError("tune_attention: the plain version on the CPU "
                             "is causal only")
        candidates = attention_candidates(sq, sk)
        default = {"block_q": min(DEFAULT_ATTENTION["block_q"], sq),
                   "block_k": min(DEFAULT_ATTENTION["block_k"], sk)}
        q_pos, k_pos = torch.arange(sq), torch.arange(sk)

        def make_thunk(cfg):
            return functools.partial(chunked_attention, q, k, v, q_pos,
                                     k_pos, window=window,
                                     q_chunk=cfg["block_q"],
                                     k_chunk=cfg["block_k"])

    def predict(cfg):
        return prune.predict_seconds(
            "flash_attention", cfg, b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d,
            causal=causal, window=window)

    return _sweep("flash_attention", key, candidates, default, make_thunk,
                  lambda out: _within_rtol(dtype, (out, ref)), predict,
                  repeats, prune_keep, profile, on_card)


def tune_ssd(*, b: int = 1, s: int = 128, h: int = 2, p: int = 32,
             g: int = 1, n: int = 32, dtype: str | None = None,
             backend: str | None = None, repeats: int = 3,
             prune_keep: int = 4, profile=None, seed: int = 1):
    """Sweep the SSD scan's chunk (on the card, its tile) for one
    workload; y and the final state are both held to the plain
    version. ``backend`` None is the card's; ``CPU_BACKEND`` sweeps the
    plain version's chunks."""
    backend = card_backend() if backend is None else backend
    on_card, device, dtype, tdt = _setting(backend, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = randn(b, s, h, p).to(tdt)
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(torch.rand((h,), generator=gen, device=device))
    B = (randn(b, s, g, n) * 0.5).to(tdt)
    C = (randn(b, s, g, n) * 0.5).to(tdt)
    D = torch.ones((h,), device=device)
    ref = ssd_reference(x, dt, A, B, C, D)
    key = ssd_key(s=s, h=h, p=p, g=g, n=n, dtype=dtype, backend=backend)
    if on_card:
        candidates = ssd_candidates(s, state_dim=n)
        default = dict(DEFAULT_CARD_SSD)
        run = ssd.ssd_chunked_kernel
    else:
        candidates = ssd_candidates(s)
        default = {"chunk": min(DEFAULT_SSD["chunk"], s)}
        run = ssd_chunked_reference

    def make_thunk(cfg):
        return functools.partial(run, x, dt, A, B, C, D, chunk=cfg["chunk"])

    def predict(cfg):
        return prune.predict_seconds("ssd", cfg, b=b, s=s, h=h, p=p, g=g,
                                     n=n)

    return _sweep("ssd", key, candidates, default, make_thunk,
                  lambda out: _within_rtol(dtype, *zip(out, ref)), predict,
                  repeats, prune_keep, profile, on_card)


# ---------------------------------------------------------------------------
# workload dicts (what the bootseer deferred task runs)
# ---------------------------------------------------------------------------


def tiny_workloads() -> list:
    """Default boot-time sweep: small shapes, seconds not minutes on the
    CPU. Real deployments pass production shape buckets (the card's
    kernels take head dims 64 and 128 and state dims 16, 64 and 128
    only)."""
    return [
        {"kernel": "flash_attention", "b": 1, "hq": 2, "hkv": 1,
         "sq": 32, "d": 16, "prune_keep": 2},
        {"kernel": "ssd", "b": 1, "s": 32, "h": 2, "p": 16, "n": 16,
         "prune_keep": 2},
    ]


def tune_workload(wl: dict, *, backend: str | None = None,
                  repeats: int = 3, profile=None):
    """Dispatch one workload dict (``{"kernel": ..., <shape kwargs>}``)
    to its sweep. ``backend`` None is the card's (``card_backend()``);
    ``CPU_BACKEND`` sweeps the plain versions."""
    wl = dict(wl)
    kernel = wl.pop("kernel")
    wl.setdefault("repeats", repeats)
    backend = card_backend() if backend is None else backend
    if kernel == "flash_attention":
        return tune_attention(backend=backend, profile=profile, **wl)
    if kernel == "ssd":
        return tune_ssd(backend=backend, profile=profile, **wl)
    raise ValueError(f"unknown tune workload kernel {kernel!r}")


def build_profile(workloads, *, backend: str | None = None,
                  repeats: int = 3, profile=None) -> TuningProfile:
    """Sweep every workload into one profile (fresh unless given), on the
    card unless ``backend`` is ``CPU_BACKEND``."""
    backend = card_backend() if backend is None else backend
    prof = profile or TuningProfile(backend=backend)
    for wl in workloads:
        tune_workload(wl, backend=backend, repeats=repeats, profile=prof)
    return prof
