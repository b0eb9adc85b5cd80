"""Sharding-aware checkpoint restore planning (BootSeer §4.4).

A *restore plan* turns "which slice of each tensor does this host own"
(derived from ``sharding.rules.Rules`` PartitionSpecs, or a plain
leading-dim row split) into a minimal set of batched byte-range reads
against the checkpoint's logical stream:

    dim slices -> per-tensor byte ranges -> coalesced ReadOps -> pread_many

Any sharded dim is supported, not just leading-dim rows: a shard that is
non-contiguous in the stream (e.g. column sharding) becomes multiple
ranges.  Adjacent/nearby ranges coalesce into batched reads with a bounded
waste fraction, so a host's counted DFS bytes stay within
``(1 + max_waste) * bytes_per_host`` instead of scaling with total
checkpoint size.  Execution lands bytes zero-copy into preallocated
per-tensor buffers through ``StripedReader.pread_many`` (one call per
wave; each physical stripe file opened at most once).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.ckpt.index import TensorEntry, TensorIndex

DEFAULT_GAP = 64 * 1024     # largest hole bridged when coalescing reads
DEFAULT_MAX_WASTE = 0.05    # bound on planned/payload byte overshoot
DEFAULT_MAX_READ = 32 * (1 << 20)   # cap on one coalesced read's span


# ---------------------------------------------------------------------------
# dim slices: PartitionSpec -> per-dim (start, size) owned by one host
# ---------------------------------------------------------------------------

def _slice_for_axes(dim: int, axes, axis_sizes: dict, coords: dict) -> tuple:
    """(start, size) of ``dim`` owned by the host at ``coords`` when the dim
    is sharded over ``axes`` (major-to-minor).  Axes absent from ``coords``
    are replicated: the host keeps the whole remaining contiguous run (a
    bounded over-read when a *finer* axis is constrained).  Non-divisible
    splits fall back to the full extent."""
    start, size = 0, dim
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        n = int(axis_sizes.get(a, 1))
        if n <= 1:
            continue
        if size % n != 0:
            return (0, dim)
        if a not in coords:
            return (start, size)
        block = size // n
        start += int(coords[a]) * block
        size = block
    return (start, size)


def dim_slices_for_spec(spec, shape: Sequence[int], axis_sizes: dict,
                        coords: dict) -> tuple:
    """Per-dim (start, size) of the shard owned by the host at ``coords``.

    ``spec`` is a PartitionSpec-like sequence: per dim either ``None``, an
    axis name, or a tuple of axis names; shorter than ``shape`` means the
    trailing dims are replicated.  ``axis_sizes`` maps axis name -> mesh
    size and ``coords`` maps axis name -> this host's coordinate; axes
    missing from ``coords`` are treated as replicated (host-level plans
    where one host holds every shard along that axis).
    """
    spec = tuple(spec) if spec is not None else ()
    out = []
    for d, dim in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        if axes is None:
            out.append((0, int(dim)))
        else:
            out.append(_slice_for_axes(int(dim), axes, axis_sizes, coords))
    return tuple(out)


# ---------------------------------------------------------------------------
# byte ranges for one tensor shard
# ---------------------------------------------------------------------------

def tensor_ranges(entry: TensorEntry,
                  slices: Sequence[tuple]) -> Iterator[tuple]:
    """Yield ``(abs_offset, length, dest_offset)`` byte ranges covering the
    shard ``slices`` of ``entry``.

    The shard is C-ordered: dest offsets are contiguous in the local shard
    buffer.  The largest fully-covered suffix of dims folds into one
    contiguous run per outer index combination, so a leading-dim row shard
    is a single range while an inner-dim shard becomes many.
    """
    shape = entry.shape
    item = np.dtype(entry.dtype).itemsize
    if not shape:
        yield (entry.offset, item, 0)
        return
    slices = tuple(slices)[:len(shape)]
    slices += tuple((0, int(s)) for s in shape[len(slices):])
    if any(n <= 0 for _, n in slices):
        return  # empty shard (0-row slice / empty tensor)
    strides = [1] * len(shape)          # element strides, C order
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    k = len(shape) - 1
    while k > 0 and slices[k] == (0, shape[k]):
        k -= 1
    run = slices[k][1] * math.prod(shape[k + 1:]) * item
    base = slices[k][0] * strides[k]
    dest = 0
    for combo in itertools.product(
            *[range(s, s + n) for s, n in slices[:k]]):
        off = base + sum(i * strides[d] for d, i in enumerate(combo))
        yield (entry.offset + off * item, run, dest)
        dest += run


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    """One scatter target inside a coalesced read."""
    src_off: int    # offset within the ReadOp's span
    length: int
    tensor: int     # index into RestorePlan.tensors
    dest_off: int   # offset within that tensor's local buffer


@dataclass(frozen=True)
class ReadOp:
    """One batched read against the logical checkpoint stream."""
    offset: int
    length: int
    segments: tuple

    @property
    def contiguous(self) -> bool:
        """Single full-span segment: eligible for zero-copy readinto."""
        return len(self.segments) == 1 and \
            self.segments[0].length == self.length


@dataclass(frozen=True)
class TensorPlan:
    name: str       # index entry name (may carry the #bf16 suffix)
    dtype: str      # stored dtype
    shape: tuple    # local shard shape
    nbytes: int


@dataclass
class RestorePlan:
    tensors: list           # list[TensorPlan], buffer order
    reads: list             # list[ReadOp], ascending offset
    payload_bytes: int      # sum of local shard bytes
    planned_bytes: int      # sum of read lengths (includes coalesce waste)

    @property
    def waste_bytes(self) -> int:
        return self.planned_bytes - self.payload_bytes


# ---------------------------------------------------------------------------
# plan building
# ---------------------------------------------------------------------------

def build_restore_plan(index: TensorIndex,
                       names: Optional[Iterable[str]] = None,
                       dim_slices: Optional[dict] = None, *,
                       gap: int = DEFAULT_GAP,
                       max_waste: float = DEFAULT_MAX_WASTE,
                       max_read: int = DEFAULT_MAX_READ) -> RestorePlan:
    """Plan the reads restoring ``names`` (default: every entry).

    ``dim_slices`` maps entry name -> per-dim (start, size); entries not in
    the map are restored in full.  Ranges are gathered across all tensors,
    sorted by stream offset, and coalesced: two ranges merge when the hole
    between them is at most ``gap`` bytes AND the merged read stays within
    ``(1 + max_waste)`` of its payload — column shards with large holes
    therefore stay as separate reads instead of degrading to full-tensor
    reads.  ``max_read`` caps one coalesced read's span so a full restore
    does not collapse into a single checkpoint-sized op (which would force
    a checkpoint-sized scratch buffer in the executor).
    """
    if names is None:
        names = [e.name for e in
                 sorted(index.entries.values(), key=lambda e: e.offset)]
    tensors: list[TensorPlan] = []
    ranges: list[tuple] = []   # (abs_off, length, tensor_idx, dest_off)
    payload = 0
    for ti, name in enumerate(names):
        e = index.entries[name]
        sl = (dim_slices or {}).get(name)
        if sl is None:
            sl = tuple((0, s) for s in e.shape)
        else:
            sl = tuple(sl)[:len(e.shape)]
            sl += tuple((0, int(s)) for s in e.shape[len(sl):])
        local_shape = tuple(n for _, n in sl) if e.shape else ()
        nbytes = (math.prod(local_shape) if e.shape else 1) \
            * np.dtype(e.dtype).itemsize
        if e.shape and any(n <= 0 for n in local_shape):
            nbytes = 0
        tensors.append(TensorPlan(name=name, dtype=e.dtype,
                                  shape=local_shape, nbytes=nbytes))
        payload += nbytes
        for off, ln, dest in tensor_ranges(e, sl):
            ranges.append((off, ln, ti, dest))
    ranges.sort()

    reads: list[ReadOp] = []
    planned = 0
    cur: Optional[list] = None  # [start, end, payload, segments]
    for off, ln, ti, dest in ranges:
        if cur is not None:
            hole = off - cur[1]
            merged_len = off + ln - cur[0]
            if 0 <= hole <= gap and merged_len <= max_read and \
                    merged_len <= (cur[2] + ln) * (1.0 + max_waste):
                cur[3].append(Segment(src_off=off - cur[0], length=ln,
                                      tensor=ti, dest_off=dest))
                cur[1] = max(cur[1], off + ln)
                cur[2] += ln
                continue
            reads.append(ReadOp(offset=cur[0], length=cur[1] - cur[0],
                                segments=tuple(cur[3])))
            planned += cur[1] - cur[0]
        cur = [off, off + ln, ln,
               [Segment(src_off=0, length=ln, tensor=ti, dest_off=dest)]]
    if cur is not None:
        reads.append(ReadOp(offset=cur[0], length=cur[1] - cur[0],
                            segments=tuple(cur[3])))
        planned += cur[1] - cur[0]
    return RestorePlan(tensors=tensors, reads=reads,
                       payload_bytes=payload, planned_bytes=planned)


def plan_for_rank(index: TensorIndex, rank: int, nodes: int,
                  names: Optional[Iterable[str]] = None,
                  **kw) -> RestorePlan:
    """Leading-dim row split across ``nodes`` (the legacy
    ``shard_fraction`` behaviour, now planned and batched): tensors with
    ``shape[0] >= nodes`` shard into contiguous row blocks — the last rank
    takes the remainder — and everything else is read in full."""
    slices = {}
    for e in index.entries.values():
        if nodes > 1 and e.shape and e.shape[0] >= nodes:
            per = e.shape[0] // nodes
            start = rank * per
            size = per if rank < nodes - 1 else e.shape[0] - start
            slices[e.name] = ((start, size),)
    return build_restore_plan(index, names=names, dim_slices=slices, **kw)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _checked_pread_many(reader, ranges, into, priority=None) -> None:
    """Issue a batched read and fail loudly on short reads: plan offsets
    always lie inside the checkpoint stream, so a short count means a
    truncated data file — returning it as tensor bytes would silently
    resume from garbage."""
    kw = {} if priority is None else {"priority": priority}
    counts = reader.pread_many(ranges, into=into, **kw)
    for (off, ln), got in zip(ranges, counts):
        if got != ln:
            raise IOError(
                f"checkpoint data truncated: read {got} of {ln} bytes at "
                f"stream offset {off}")


def execute_plan(reader, plan: RestorePlan, *,
                 priority: Optional[int] = None) -> list[np.ndarray]:
    """Run a plan's batched reads through ``reader.pread_many`` and return
    one array per TensorPlan (stored dtype, local shard shape).

    Contiguous ops read zero-copy straight into the preallocated per-tensor
    buffers; gap-coalesced multi-segment ops go through one scratch buffer
    and scatter out (bounded by the plan's ``max_waste``).
    """
    bufs = [np.empty(t.nbytes, np.uint8) for t in plan.tensors]
    ranges: list[tuple] = []
    into: list = []
    scatter: list[tuple] = []
    for op in plan.reads:
        ranges.append((op.offset, op.length))
        if op.contiguous:
            s = op.segments[0]
            into.append(bufs[s.tensor][s.dest_off:s.dest_off + s.length])
        else:
            scratch = np.empty(op.length, np.uint8)
            into.append(scratch)
            scatter.append((op, scratch))
    if ranges:
        _checked_pread_many(reader, ranges, into, priority=priority)
    for op, scratch in scatter:
        for s in op.segments:
            bufs[s.tensor][s.dest_off:s.dest_off + s.length] = \
                scratch[s.src_off:s.src_off + s.length]
    out = []
    for t, buf in zip(plan.tensors, bufs):
        if t.nbytes:
            out.append(buf.view(t.dtype).reshape(t.shape))
        else:
            out.append(np.empty(t.shape, t.dtype))
    return out


def read_plan(reader, plan: RestorePlan, *,
              batch_bytes: int = 4 * DEFAULT_MAX_READ,
              priority: Optional[int] = None) -> int:
    """Execute only the I/O of a plan (no tensor materialization) — the
    startup-critical resume read in the BootSeer runtime.  Ops are issued
    in batches whose throwaway buffers total at most ``batch_bytes``, so N
    concurrent node restores peak at ~N x batch_bytes transient memory
    instead of N x checkpoint_size.  Batching also bounds how long one
    scheduler token is held: with a ``priority``-aware reader, a DEFERRED
    opt-state wave yields to CRITICAL reads at batch granularity.
    Returns the number of bytes read — including, for a fabric reader
    that had to reconstruct a lost stripe from parity mid-plan, the extra
    source bytes of the degraded read (``reconstruction_read_bytes``
    delta), so callers report the I/O that actually hit the DFS rather
    than the healthy-path plan size."""
    stats = getattr(reader, "stats", None)
    recon0 = stats.get("reconstruction_read_bytes", 0) if stats else 0
    ops = plan.reads
    i = 0
    while i < len(ops):
        j, acc = i, 0
        while j < len(ops) and (j == i or acc + ops[j].length <= batch_bytes):
            acc += ops[j].length
            j += 1
        _checked_pread_many(reader,
                            [(op.offset, op.length) for op in ops[i:j]],
                            [np.empty(op.length, np.uint8)
                             for op in ops[i:j]],
                            priority=priority)
        i = j
    extra = (stats.get("reconstruction_read_bytes", 0) - recon0) \
        if stats else 0
    return plan.planned_bytes + extra
