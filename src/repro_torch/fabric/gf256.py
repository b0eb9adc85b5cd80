"""GF(256) arithmetic and Cauchy Reed-Solomon coding (pure numpy).

The storage fabric's erasure placement codes ``k`` data stripe files with
``m`` parity stripe files so any ``m`` lost files reconstruct from the
survivors (an MDS code).  Everything here is byte-wise over the field
GF(2^8) with the AES-ish polynomial ``x^8+x^4+x^3+x^2+1`` (0x11d, the
classic Rijndael-adjacent choice used by most RS storage systems):

* multiplication by a *fixed* coefficient is a single 256-entry table
  lookup, so numpy fancy indexing vectorizes an entire stripe-chunk
  multiply into one ``take`` — no per-byte Python;
* the generator is **systematic Cauchy**: data shards are stored verbatim
  and the parity rows come from a Cauchy matrix ``C[i][j] =
  1/(x_i + y_j)``.  Every square submatrix of a Cauchy matrix is
  invertible, which (unlike a naive Vandermonde stack) guarantees ANY k
  of the k+m shards decode — the property the fault-tolerance story
  rests on.

Only encode/decode of equal-length byte blocks lives here; how blocks map
onto stripe files is the placement layer's job (repro_torch.fabric.placement /
repro_torch.dfs.striped).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_POLY = 0x11D

# EXP doubled so EXP[LOG[a] + LOG[b]] never needs an explicit mod 255
EXP = np.zeros(510, dtype=np.uint8)
LOG = np.zeros(256, dtype=np.int64)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
EXP[255:510] = EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(EXP[255 - LOG[a]])


# per-coefficient multiplication tables: MUL_TABLE(c)[b] == c * b.
# Built lazily and cached — a (k+m)-wide code touches at most k*m distinct
# coefficients plus whatever a decode matrix produces.
_MUL_TABLES: Dict[int, np.ndarray] = {}


def mul_table(c: int) -> np.ndarray:
    t = _MUL_TABLES.get(c)
    if t is None:
        if c == 0:
            t = np.zeros(256, dtype=np.uint8)
        else:
            t = np.empty(256, dtype=np.uint8)
            t[0] = 0
            b = np.arange(1, 256)
            t[1:] = EXP[LOG[c] + LOG[b]]
        _MUL_TABLES[c] = t
    return t


def gf_mul_bytes(c: int, data: np.ndarray) -> np.ndarray:
    """c * data, element-wise over GF(256) — one vectorized table lookup."""
    if c == 0:
        return np.zeros_like(data)
    if c == 1:
        return data.copy()
    return mul_table(c)[data]


def cauchy_matrix(m: int, k: int) -> List[List[int]]:
    """m x k Cauchy matrix C[i][j] = 1/(x_i + y_j) with x_i = k+i, y_j = j.

    All x and y values are distinct elements of GF(256) (requires
    k + m <= 256), so every square submatrix is invertible.
    """
    if k + m > 256:
        raise ValueError(f"k+m must be <= 256 for GF(256), got {k}+{m}")
    return [[gf_inv((k + i) ^ j) for j in range(k)] for i in range(m)]


def gf_matinv(a: Sequence[Sequence[int]]) -> List[List[int]]:
    """Invert a small square matrix over GF(256) (Gauss-Jordan).

    k is the stripe width (<= a few dozen), so plain Python loops over
    rows are fine; the expensive part of decode is the byte-vector math,
    which goes through the vectorized tables.
    """
    n = len(a)
    aug = [list(row) + [1 if i == j else 0 for j in range(n)]
           for i, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r][col] != 0), None)
        if piv is None:
            raise ValueError("singular matrix over GF(256)")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv_p = gf_inv(aug[col][col])
        aug[col] = [gf_mul(v, inv_p) for v in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [v ^ gf_mul(f, w)
                          for v, w in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


def _combine(coeffs: Sequence[int],
             blocks: Sequence[np.ndarray]) -> np.ndarray:
    """XOR-sum of coeff_i * block_i (one output shard's worth of math)."""
    out: Optional[np.ndarray] = None
    for c, b in zip(coeffs, blocks):
        if c == 0:
            continue
        term = gf_mul_bytes(c, b)
        if out is None:
            out = term
        else:
            np.bitwise_xor(out, term, out=out)
    if out is None:
        out = np.zeros_like(blocks[0])
    return out


def rs_encode(data: Sequence[np.ndarray], m: int) -> List[np.ndarray]:
    """``m`` parity blocks over ``k = len(data)`` equal-length data blocks."""
    k = len(data)
    c = cauchy_matrix(m, k)
    return [_combine(c[i], data) for i in range(m)]


def rs_decode(shards: Dict[int, np.ndarray], k: int, m: int,
              want: Iterable[int]) -> Dict[int, np.ndarray]:
    """Reconstruct shards from any ``k`` survivors.

    ``shards``: shard index -> byte block; indices 0..k-1 are data, k..k+m-1
    parity.  ``want``: indices to reconstruct (data or parity).  Raises
    ``ValueError`` when fewer than k shards are present (more than m
    failures: the code's recovery bound).
    """
    want = list(want)
    if len(shards) < k:
        raise ValueError(
            f"need at least k={k} shards to decode, have {len(shards)} "
            f"(lost {k + m - len(shards)} > m={m})")
    cau = cauchy_matrix(m, k)

    def gen_row(idx: int) -> List[int]:
        if idx < k:
            return [1 if j == idx else 0 for j in range(k)]
        return cau[idx - k]

    use = sorted(shards)[:k]
    a = [gen_row(i) for i in use]
    inv = gf_matinv(a)          # data_j = sum_l inv[j][l] * shard_use[l]
    used_blocks = [shards[i] for i in use]
    out: Dict[int, np.ndarray] = {}
    data_cache: Dict[int, np.ndarray] = {}

    def data_shard(j: int) -> np.ndarray:
        if j in data_cache:
            return data_cache[j]
        blk = shards[j] if j in shards else _combine(inv[j], used_blocks)
        data_cache[j] = blk
        return blk

    for idx in want:
        if idx in shards:
            out[idx] = shards[idx]
        elif idx < k:
            out[idx] = data_shard(idx)
        else:  # lost parity: re-encode from (possibly reconstructed) data
            out[idx] = _combine(cau[idx - k],
                                [data_shard(j) for j in range(k)])
    return out
