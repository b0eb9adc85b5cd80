"""Incremental delta checkpoints (continuous recovery, ROADMAP item 2).

A *full* snapshot writes every tensor's bytes and records a CRC32 per
``hash_chunk``-sized chunk of each tensor in its manifest
(repro_torch.ckpt.index).  A *delta* save re-hashes the new state, diffs it
against the base manifest's chunk hashes — no base data is re-read — and
writes only the changed byte ranges, concatenated in logical-stream order,
into a ``.delta`` data file.  The delta manifest keeps the base's tensor
entries verbatim (congruent trees ⇒ identical logical layout), carries the
*new* chunk hashes (so the next delta can chain against this step), and a
``delta`` descriptor mapping each written range back to its logical
offset.

Restore composes the chain: :func:`build_layer_map` overlays each delta's
ranges (oldest → newest) onto the base's full extent, producing a sorted,
non-overlapping interval map in which every logical byte is owned by the
NEWEST layer that holds it.  :class:`LayeredReader` then serves the
ordinary ``pread``/``pread_many`` reader contract over that map — a
restore plan executes against it unchanged, each logical range is read
exactly once, and every byte comes from exactly one layer's file.
"""

from __future__ import annotations

import zlib
from bisect import bisect_right
from typing import Iterator, Optional, Sequence

DEFAULT_DIFF_CHUNK = 64 * 1024   # granularity of the save_delta CRC diff


def chunk_crcs(data: bytes, chunk: int) -> list[int]:
    """CRC32 per ``chunk``-sized slice of ``data`` (last one may be
    short).  Empty payloads hash to an empty list."""
    return [zlib.crc32(data[lo:lo + chunk])
            for lo in range(0, len(data), chunk)]


def changed_ranges(data: bytes, old: Sequence[int], chunk: int,
                   base_offset: int = 0) -> Iterator[tuple[int, int]]:
    """Yield coalesced ``(offset, length)`` ranges of ``data`` whose chunk
    CRC differs from ``old`` (the base's hashes for the same tensor).
    Chunks past the end of ``old`` count as changed — a defensive case;
    congruent trees always have equal chunk counts.  Offsets are shifted
    by ``base_offset`` (the tensor's position in the logical stream)."""
    cur: Optional[list] = None   # [start, end]
    for ci, lo in enumerate(range(0, len(data), chunk)):
        hi = min(lo + chunk, len(data))
        if ci < len(old) and zlib.crc32(data[lo:hi]) == old[ci]:
            if cur is not None:
                yield (base_offset + cur[0], cur[1] - cur[0])
                cur = None
            continue
        if cur is not None and cur[1] == lo:
            cur[1] = hi
        else:
            if cur is not None:
                yield (base_offset + cur[0], cur[1] - cur[0])
            cur = [lo, hi]
    if cur is not None:
        yield (base_offset + cur[0], cur[1] - cur[0])


# ---------------------------------------------------------------------------
# layer composition
# ---------------------------------------------------------------------------

def build_layer_map(total_bytes: int,
                    layer_ranges: Sequence[Sequence[tuple]]) -> list:
    """Compose a delta chain into one interval map.

    ``layer_ranges[i]`` holds layer ``i+1``'s ``(logical_offset, length,
    layer_stream_offset)`` triples, ordered oldest delta first; layer 0 is
    the base snapshot, which owns the full ``[0, total_bytes)`` extent.
    Returns a sorted, non-overlapping list of ``(start, end, layer,
    src_off)`` segments where ``src_off`` is the segment's offset within
    layer ``layer``'s own data stream — each logical byte owned by the
    newest layer that wrote it.
    """
    segs: list[tuple[int, int, int, int]] = [(0, total_bytes, 0, 0)]
    for layer, ranges in enumerate(layer_ranges, start=1):
        for lo, ln, src in sorted(ranges):
            hi = lo + ln
            if ln <= 0:
                continue
            out: list[tuple[int, int, int, int]] = []
            for s, e, lay, soff in segs:
                if e <= lo or s >= hi:    # disjoint: keep
                    out.append((s, e, lay, soff))
                    continue
                if s < lo:                # left remainder survives
                    out.append((s, lo, lay, soff))
                if e > hi:                # right remainder survives
                    out.append((hi, e, lay, soff + (hi - s)))
            out.append((lo, hi, layer, src))
            out.sort()
            segs = out
    return segs


class LayeredReader:
    """``pread``/``pread_many`` over a composed base + delta chain.

    ``readers[i]`` serves layer ``i``'s data stream (a ``StripedReader``
    or ``_PlainReader`` on the layer's physical file); ``segments`` is the
    :func:`build_layer_map` output.  A logical range is split at segment
    boundaries and each piece is read from its owning layer — grouped so
    every layer sees ONE ``pread_many`` call per request, preserving the
    open-each-file-at-most-once batching underneath.
    """

    def __init__(self, readers: Sequence, segments: list, size: int):
        self.readers = list(readers)
        self.segments = segments
        self.size = size
        self._starts = [s for s, _e, _l, _o in segments]

    @property
    def stats(self) -> dict:
        """Aggregated fabric counters across all layers (the
        ``read_plan`` reconstruction-delta contract)."""
        out: dict = {}
        for r in self.readers:
            for k, v in getattr(r, "stats", {}).items():
                out[k] = out.get(k, 0) + v
        return out

    def _split(self, off: int, ln: int) -> Iterator[tuple[int, int, int, int]]:
        """Yield ``(layer, src_off, length, dest_off)`` pieces of one
        logical range, dest offsets relative to the range start."""
        end = off + ln
        i = max(bisect_right(self._starts, off) - 1, 0)
        while i < len(self.segments):
            s, e, lay, soff = self.segments[i]
            if s >= end:
                break
            lo = max(off, s)
            hi = min(end, e)
            if hi > lo:
                yield (lay, soff + (lo - s), hi - lo, lo - off)
            i += 1

    def pread(self, offset: int, length: int) -> bytes:
        return self.pread_many([(offset, length)])[0]

    def pread_many(self, ranges: Sequence[tuple[int, int]],
                   into: Optional[Sequence] = None,
                   priority: Optional[int] = None):
        clamped = [(off, max(0, min(ln, self.size - off)))
                   for off, ln in ranges]
        bufs: list = []
        views: list = []
        for i, (off, ln) in enumerate(clamped):
            if into is None:
                b = bytearray(ln)
                bufs.append(b)
                views.append(memoryview(b))
            else:
                bufs.append(ln)
                views.append(memoryview(into[i]) if ln else None)
        # split every range at layer boundaries, group per layer
        per_layer: dict[int, list[tuple[tuple[int, int], memoryview]]] = {}
        for i, (off, ln) in enumerate(clamped):
            if ln <= 0:
                continue
            for lay, src, n, dest in self._split(off, ln):
                per_layer.setdefault(lay, []).append(
                    ((src, n), views[i][dest:dest + n]))
        for lay, jobs in per_layer.items():
            sub_ranges = [r for r, _v in jobs]
            sub_views = [v for _r, v in jobs]
            counts = self.readers[lay].pread_many(sub_ranges, into=sub_views,
                                                  priority=priority)
            for (_, want), got in zip(sub_ranges, counts):
                if got != want:
                    raise IOError(
                        f"delta layer {lay} short read: {got} of {want} "
                        "bytes")
        if into is None:
            return [bytes(b) for b in bufs]
        return bufs
