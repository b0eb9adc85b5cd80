"""The port's kernels priced from their shapes and launch configs.

Two kinds of figure, for two readers:

* Bounds (``attention_bound``, ``ssd_bound`` and the backwards'): the
  least time the card could take for a kernel's work, the larger of its
  least FLOPs over the peak rate and its compulsory bytes (each input read
  once, each output written once) over the memory rate. They do not depend
  on the launch config. ``chip_smoke.py`` prints each kernel's share of its
  bound with them.
* Costs (``flash_cost``, ``ssd_cost``): what one launch config does,
  ``(flops, bytes, grid_steps)`` with the FLOPs and bytes of one step, for
  the autotuner's pruning (``repro_torch.tune.prune``). This takes the
  place of the JAX package's jaxpr walker over ``pallas_call``
  (``roofline/jaxpr_cost.pallas_costs``), which the CUDA kernels have no
  jaxpr for. A step is one round of the card's block slots (132 SMs times
  the blocks an SM holds): the steps are the serial part of a launch. The
  FLOPs count whole tiles, masked parts included, and the bytes every tile
  a block loads: the flash forward reads K and V once for each q tile, so
  a smaller ``block_q`` reads them more often.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.ssd import TILE
from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS,
                                           PEAK_FP32_FLOPS)

SMS = 132  # streaming multiprocessors of an H100 SXM


def _bound(flops: float, nbytes: float,
           peak_flops: float) -> tuple[float, str]:
    ops_ms = 1e3 * flops / peak_flops
    bytes_ms = 1e3 * nbytes / HBM_BW
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def attention_flops(b: int, hq: int, s: int, d: int) -> int:
    """Causal attention's work: 4*d FLOPs per unmasked (q, k) pair."""
    return 4 * d * (s * (s + 1) // 2) * b * hq


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """(q, k) pairs one head attends, row r at position q = r +
    ``q_offset``: k < Sk, k <= q if causal, k > q - window if windowed."""
    r = np.arange(sq) + q_offset
    hi = np.minimum(r, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_bwd_bound(b: int, hq: int, hkv: int, s: int, d: int,
                        pairs: int) -> tuple[float, str]:
    """Least time (ms) for the attention backward: 10*d FLOPs per unmasked
    pair (S recomputed, dV, dP, dK, dQ) over the bf16 peak, or one read of
    q, k, v, dO and the fp32 LSE and one write of dq, dk, dv over the
    memory rate; and which of the two sets it."""
    nbytes = 2 * b * s * d * (3 * hq + 4 * hkv) + 4 * b * hq * s
    return _bound(10 * d * pairs * b * hq, nbytes, PEAK_FLOPS)


def attention_bound(b: int, hq: int, hkv: int, s: int,
                    d: int) -> tuple[float, str]:
    """Least time (ms) for causal attention on these shapes, and what sets
    it: its FLOPs over the bf16 peak, or one read of q, k, v and one write
    of o over the memory rate."""
    return _bound(attention_flops(b, hq, s, d),
                  2 * b * s * d * (2 * hq + 2 * hkv), PEAK_FLOPS)


def ssd_flops(b: int, s: int, h: int, p: int, g: int, n: int, *,
              tile: int = TILE) -> int:
    """The SSD scan's least work at the kernel's tile L: per (batch, group,
    tile) the lower triangle of C . B^T, 2 N FLOPs per (i >= j) pair; per
    (batch, head, tile) the triangle of M @ x, 2 P per pair; per token and
    head the inter-chunk term and the state update, 2 N P each. Decays and
    dt weights are O(S H) and left out."""
    tiles = -(-s // tile)
    pairs = tile * (tile + 1) // 2
    return (b * g * tiles * pairs * 2 * n + b * h * tiles * pairs * 2 * p
            + b * h * s * 4 * n * p)


def ssd_bound(b: int, s: int, h: int, p: int, g: int, n: int, *,
              peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the SSD scan on these shapes at ``peak_flops``
    (the kernel's products run on bf16 tensor cores), and what sets it:
    ``ssd_flops``, or one read of x, dt, B, C and one write of y (bf16
    except dt) and of the fp32 final state."""
    nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * g * n
              + 4 * b * h * p * n)
    return _bound(ssd_flops(b, s, h, p, g, n), nbytes, peak_flops)


def ssd_bwd_flops(b: int, s: int, h: int, p: int, g: int, n: int) -> int:
    """The SSD backward's least work, reckoned as ``ssd_flops``: per
    (batch, group, tile) the triangle of C . B^T (recomputed), 2 N per
    pair; per (batch, head, tile) the triangles of dy . x^T and M^T dy (2 P
    per pair each) and of the dB and dC sums (2 N each); per token and head
    five [P, N] products, 2 N P each: the state recomputed, S_in^T dy,
    dS_out B, dS_out^T x and the state gradient's update."""
    tiles = -(-s // TILE)
    pairs = TILE * (TILE + 1) // 2
    return (b * g * tiles * pairs * 2 * n
            + b * h * tiles * pairs * (4 * p + 4 * n) + b * h * s * 10 * n * p)


def ssd_bwd_bound(b: int, s: int, h: int, p: int, g: int, n: int, *,
                  peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the SSD backward at ``peak_flops``, and what
    sets it: ``ssd_bwd_flops``, or one read of x, dy, B, C, dt and one
    write of dx, dB, dC, ddt (bf16 except dt and ddt; dA, dD are [H])."""
    nbytes = 3 * 2 * b * s * h * p + 4 * 2 * b * s * g * n + 2 * 4 * b * s * h
    return _bound(ssd_bwd_flops(b, s, h, p, g, n), nbytes, peak_flops)


def unembed_ce_flops(t: int, d: int, v: int, *,
                     backward: bool = False) -> int:
    """The vocab-chunked unembedding and cross-entropy's least work: the
    product h @ W, 2 T d V, forward; dh and dW, 4 T d V, backward. The
    operator's own arithmetic is more (``unembed_ce_bound``), as the
    bf16-intra SSD instances' is the kernel's, not the function's."""
    return (4 if backward else 2) * t * d * v


def unembed_ce_bound(t: int, d: int, v: int, *,
                     bf16: bool = True) -> tuple[float, str]:
    """The operator's forward and backward (``kernels/unembed_ce.py``),
    its own arithmetic: the logits forward and again backward, 2 T d V
    each, and with bf16 operands dh and dW on the three planes, 6 T d V
    each (16 T d V on the tensor cores), with fp32 ones on g, 2 T d V each
    (8 T d V at the fp32 rate); bytes: h, the table and their gradients
    once, in the operands' dtype."""
    size = 2 if bf16 else 4
    flops = (16 if bf16 else 8) * t * d * v
    return _bound(flops, 2 * size * (t * d + d * v),
                  PEAK_FLOPS if bf16 else PEAK_FP32_FLOPS)


def ce_fold_bound(t: int, w: int) -> tuple[float, str]:
    """``ce_fold_kernel`` on one chunk of fp32 logits [T, w]: it reads them
    once, and each row's three running values and labels."""
    return _bound(0, 4 * t * w + 16 * t, PEAK_FLOPS)


def ce_grad_bound(t: int, w: int, *, planes: bool = True
                  ) -> tuple[float, str]:
    """``ce_grad_kernel`` on one chunk [T, w]: it reads the fp32 logits
    once and writes three bf16 planes (6 bytes an element) or fp32 g."""
    return _bound(0, 4 * t * w + (6 if planes else 4) * t * w + 8 * t,
                  PEAK_FLOPS)


def _steps(chains: np.ndarray, slots: int) -> int:
    """The serial steps of blocks whose chains of tile steps are
    ``chains``, ``slots`` at a time, longest first: their sum spread over
    the slots, and never fewer than the longest chain."""
    return int(max(-(-int(chains.sum()) // slots), int(chains.max(initial=0)),
                   1))


def flash_cost(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, *,
               causal: bool = True, window: int = 0, block_q: int = 128,
               block_k: int = 64, q_offset: int = 0) -> tuple[float, float, int]:
    """The flash forward at (``block_q``, ``block_k``): (FLOPs of a step,
    bytes of a step, steps). A block takes one (batch, q head, q tile) and
    walks the key tiles its rows can see, by the kernel's rules
    (csrc/flash_attention.cu): 4 d FLOPs for every (q, k) of each whole
    tile, the Q tile and the O tile once, a K and a V tile for each key
    tile; row r stands at position r + ``q_offset``. A block of 64 q rows is one consumer warpgroup, two to an SM;
    larger ones are one to an SM. ``hkv`` does not change the cost: every
    block reads its own K and V tiles."""
    del hkv
    q_tiles = -(-sq // block_q)
    q_lo = np.arange(q_tiles) * block_q + q_offset
    kt_end = np.full(q_tiles, -(-sk // block_k))
    if causal:
        kt_end = np.minimum(kt_end, (q_lo + block_q - 1) // block_k + 1)
    kt_begin = np.zeros(q_tiles, int)
    if window > 0:
        kt_begin = np.where(q_lo - window + 1 > 0,
                            (q_lo - window + 1) // block_k, 0)
    tiles = np.clip(kt_end - kt_begin, 0, None)       # key tiles a q tile
    heads = b * hq
    key_tiles = int(tiles.sum()) * heads
    flops = 4.0 * d * block_q * block_k * key_tiles
    nbytes = 2.0 * d * (2 * block_q * q_tiles * heads
                        + 2 * block_k * key_tiles)
    slots = SMS * (2 if block_q <= 64 else 1)
    steps = _steps(np.repeat(tiles, heads), slots)
    return flops / steps, nbytes / steps, steps


def ssd_cost(b: int, s: int, h: int, p: int, g: int, n: int, *,
             chunk: int = TILE) -> tuple[float, float, int]:
    """The SSD forward at a tile of ``chunk``: (FLOPs of a step, bytes of
    a step, steps). A block takes one (batch, head) and walks its tiles in
    order, each a step of its chain: the tile's triangle of C B^T (2 N per
    pair, once a head) and of M x (2 P per pair), the inter term and the
    state update (2 N P each a position); it loads the tile's x, dt, B and
    C, writes its y, and writes the fp32 state once. Two blocks to an SM.
    ``g`` does not change the cost: every head reads its group's B and C."""
    del g
    tiles = -(-s // chunk)
    pairs = chunk * (chunk + 1) // 2
    blocks = b * h
    flops = blocks * tiles * (pairs * 2 * (n + p) + chunk * 4 * n * p)
    nbytes = blocks * (tiles * chunk * (2 * 2 * p + 4 + 2 * 2 * n)
                       + 4 * p * n)
    steps = _steps(np.full(blocks, tiles), 2 * SMS)
    return flops / steps, nbytes / steps, steps
