"""Checkpointing of trees of tensors over the (striped) DFS — BootSeer §4.4:
the JAX package's ``ckpt/checkpoint.py`` for PyTorch, writing and reading
the same files.

Trees are nested dicts, lists and tuples of tensors (the port's params and
AdamW state). Their entries get the reference's names, ``jax.tree_util.
keystr`` of the leaf's path with dict keys in sorted order (``t1['mu']
['layers']['wq']``), prefixed by the tree's position (``t0`` params, ``t1``
optimizer state). bf16 leaves are stored as their uint16 bit patterns under
a ``#bf16`` suffix; every other dtype is stored as it is. So the data
stream, the manifest (names, dtypes, shapes, offsets, chunk CRCs) and the
striped files are byte for byte the reference's, and each package restores
the other's checkpoints.

Save streams leaf by leaf: a leaf on a card is copied to the host in pieces
through one reused pinned buffer, each piece's chunk CRCs are taken (on a
pool of their own) while it goes to ``StripedWriter.write``. The reference
holds every payload as ``bytes`` at once, which for qwen2.5-3b's fp32
masters and AdamW state would be 40.84 GB of host memory.

Restore plans this host's reads from the manifest (``repro_torch.ckpt.plan``)
and runs them in two waves: wave 0, the params, at ``priority``
(CRITICAL), then the optimizer state at ``tail_priority`` (DEFERRED), which
with ``async_tail=True`` streams on a background pool while wave 0's last
copies land and the caller builds its kernels. Onto a card, ``pread_many``
reads zero copy into a small ring of pinned host buffers, each copied on
to the card while the next is read, so the host holds 512 MiB of either
wave at a time and page-locks only that. Delta checkpoints
(``save_delta``) and their chains restore through the same waves. A
failed read, or a failed copy to the device, raises; nothing falls back to the host.
"""

from __future__ import annotations

import contextvars
import os
import re
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.ckpt.delta import (DEFAULT_DIFF_CHUNK, LayeredReader,
                                    build_layer_map)
from repro_torch.ckpt.index import TensorIndex
from repro_torch.ckpt.plan import (RestorePlan, _checked_pread_many,
                                   build_restore_plan, dim_slices_for_spec)
from repro_torch.core.pipeline import CRITICAL, DEFERRED
from repro_torch.core.profiler import span
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.dfs.striped import (StripedReader, StripedWriter,
                                     pread_many_fallback)

# bytes of a leaf copied to the host at a time on save; a multiple of any
# diff chunk that divides it, so each piece's chunk CRCs continue the last's
PIECE_BYTES = 64 << 20
# a restore onto a card reads through this many pinned buffers of this
# size (a ring: one slot is read into while the other is copied on)
RING_SLOTS, RING_BYTES = 2, 256 << 20

_TORCH_TO_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
                   torch.float16: np.float16, torch.int64: np.int64,
                   torch.int32: np.int32, torch.int16: np.int16,
                   torch.int8: np.int8, torch.uint8: np.uint8,
                   torch.bool: np.bool_}
_NUMPY_TO_TORCH = {np.dtype(n).name: t for t, n in _TORCH_TO_NUMPY.items()}
_NUMPY_TO_TORCH["uint16"] = torch.uint16

# process-wide pools, made at first use and never shut down (the
# reference's shape, so no resume pays for thread creation): the optimizer
# tails, and the chunk CRCs of a save, which must not run on the DFS I/O
# pool since the save waits on them while that pool writes
_POOL_LOCK = threading.Lock()
_POOLS: dict[str, ThreadPoolExecutor] = {}
_POOL_THREADS = max(2, min(8, os.cpu_count() or 2))


def _pool(name: str) -> ThreadPoolExecutor:
    with _POOL_LOCK:
        if name not in _POOLS:
            _POOLS[name] = ThreadPoolExecutor(
                _POOL_THREADS, thread_name_prefix=f"ckpt-{name}")
        return _POOLS[name]


def flat_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) in ``jax.tree_util.tree_flatten_with_path`` order with
    ``keystr`` names: dict keys sorted, as ``['key']``; list and tuple
    items as ``[i]``; a bare leaf as ``""``."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flat_with_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in flat_with_names(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _flat_specs(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """A spec tree's (name, spec) pairs: nested dicts congruent to the
    trees' dicts, each leaf a PartitionSpec-like sequence or None."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flat_specs(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _dtensor_spec(t) -> Optional[tuple]:
    """A DTensor's layout as a PartitionSpec-like tuple: per dim the mesh
    axes that shard it (None: replicated); None for a plain tensor."""
    if not _is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names
    axes: list = [[] for _ in range(t.ndim)]
    for m, p in enumerate(t.placements):
        if p.is_partial():
            raise ValueError("checkpoint: a partial DTensor has no layout")
        if p.is_shard():
            axes[p.dim].append(names[m])
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in axes)


def _spec_tree(like: Any) -> Any:
    if isinstance(like, dict):
        return {k: _spec_tree(v) for k, v in like.items()}
    return _dtensor_spec(like)


def _gathered_on_rank0(method):
    """``save`` and ``save_delta`` of trees holding DTensors: every rank
    gathers each leaf to full size (a collective) and rank 0 writes it, as
    the reference's ``np.asarray`` gathers to the host; every rank waits
    for the write, then sees it (``HdfsCluster.refresh``), and rank 0
    returns the manifest (the others None). One leaf at a time is whole on
    a device: rank 0 copies it to the host at once, the others drop it, so
    a model that only fits the mesh sharded can still be saved."""
    import functools

    @functools.wraps(method)
    def wrapped(self, step, *trees, **kw):
        if not any(_is_dtensor(leaf) for tree in trees
                   for _, leaf in flat_with_names(tree)):
            return method(self, step, *trees, **kw)
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0

        def to_host(leaf):
            if not _is_dtensor(leaf):
                return leaf
            whole = leaf.full_tensor()
            # a copy on a CPU mesh too: the gathered buffer goes at once
            return whole.to("cpu", copy=True) if rank0 else None

        host = tuple(_unflatten(tree, iter(
            to_host(leaf) for _, leaf in flat_with_names(tree)))
            for tree in trees)
        try:
            return method(self, step, *host, **kw) if rank0 else None
        finally:
            dist.barrier()
            if dist.get_rank() != 0:
                self.hdfs.refresh()

    return wrapped


def _unflatten(like: Any, leaves: Iterator) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _stored(leaf: torch.Tensor) -> tuple[str, np.dtype]:
    """The entry-name suffix and the stored numpy dtype of a tensor."""
    if leaf.dtype == torch.bfloat16:
        return "#bf16", np.dtype(np.uint16)
    if leaf.dtype not in _TORCH_TO_NUMPY:
        raise TypeError(f"checkpoint: no stored form for {leaf.dtype}")
    return "", np.dtype(_TORCH_TO_NUMPY[leaf.dtype])


def _chunk_crcs(view: memoryview, chunk: int) -> list[Future]:
    """``delta.chunk_crcs`` of one piece as futures of consecutive runs of
    it, one per thread of the CRC pool (zlib releases the GIL on large
    buffers)."""
    n = len(view)
    per = max(chunk, -(-n // (_POOL_THREADS * chunk)) * chunk)

    def crcs(lo, hi):
        return [zlib.crc32(view[a:min(a + chunk, hi)])
                for a in range(lo, hi, chunk)]

    return [_pool("crc").submit(crcs, lo, min(lo + per, n))
            for lo in range(0, n, per)]


def _gather(futs: list[Future]) -> list[int]:
    return [c for f in futs for c in f.result()]


class _Staging:
    """A leaf's bytes, piece by piece: a CPU tensor's own memory, or a card
    tensor's copied through one reused pinned host buffer."""

    def __init__(self, piece: int):
        self.piece = piece
        self._buf: Optional[torch.Tensor] = None

    copy_s = 0.0   # seconds spent copying from a card

    def pieces(self, leaf: torch.Tensor, lo: int = 0,
               hi: Optional[int] = None) -> Iterator[memoryview]:
        """Bytes [lo, hi) of ``leaf`` in its stored form, in pieces of at
        most ``piece`` bytes; each piece is valid until the next is asked
        for."""
        raw = leaf.detach().reshape(-1).view(torch.uint8)
        hi = raw.numel() if hi is None else hi
        if raw.device.type == "cpu":
            host = raw.contiguous().numpy()
            for a in range(lo, hi, self.piece):
                yield memoryview(host[a:min(a + self.piece, hi)])
            return
        if self._buf is None:
            self._buf = torch.empty(self.piece, dtype=torch.uint8,
                                    pin_memory=True)
        for a in range(lo, hi, self.piece):
            n = min(self.piece, hi - a)
            t0 = time.perf_counter()
            self._buf[:n].copy_(raw[a:a + n])   # synchronous D2H
            self.copy_s += time.perf_counter() - t0
            yield memoryview(self._buf[:n].numpy())


class _PlainReader:
    """Range reads over a non-striped checkpoint file, with the same
    ``pread``/``pread_many`` contract as ``StripedReader`` — including
    scheduler metering: with ``sched`` attached, a batch holds one "dfs"
    token at its (per-call overridable) priority for the duration."""

    def __init__(self, hdfs: HdfsCluster, path: str, *, sched=None,
                 priority: int = 0):
        self._hdfs = hdfs
        self._path = path
        self.sched = sched
        self.priority = priority
        self.stats = {"degraded_reads": 0, "reconstructed_bytes": 0,
                      "reconstruction_read_bytes": 0, "corrupt_chunks": 0}

    def pread(self, off: int, ln: int) -> bytes:
        return self._hdfs.pread(self._path, off, ln)

    def pread_many(self, ranges, into=None, priority=None):
        prio = self.priority if priority is None else priority
        if self.sched is not None:
            nbytes = sum(ln for _, ln in ranges)
            with self.sched.slot("dfs", priority=prio, nbytes=nbytes):
                return pread_many_fallback(self.pread, ranges, into=into)
        return pread_many_fallback(self.pread, ranges, into=into)


class Checkpointer:
    """The reference's ``Checkpointer`` over trees of tensors: the same
    paths, file formats, placements (``"striped"``, ``"replicated"``,
    ``Placement.erasure(m)``) and delta chains. After each save and restore
    ``timings`` holds what it took: a save's bytes and seconds (copying
    from the card, writing, waiting on the CRCs); a restore's wave 0 bytes,
    allocation, read and last wait for its copies, and the tail's bytes
    and seconds."""

    def __init__(self, hdfs: HdfsCluster, base: str = "/ckpt", *,
                 striped: bool = True, width: int = 8, threads: int = 8,
                 placement=None, chunk: Optional[int] = None,
                 stripe: Optional[int] = None,
                 diff_chunk: int = DEFAULT_DIFF_CHUNK):
        from repro_torch.dfs.striped import CHUNK, STRIPE
        self.hdfs = hdfs
        self.base = base.rstrip("/")
        self.striped = striped
        self.width = width
        self.threads = threads
        self.placement = placement
        self.chunk = chunk or CHUNK
        self.stripe = stripe or STRIPE
        self.diff_chunk = diff_chunk
        self.timings: dict = {}

    # ----- paths -----

    def data_path(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}.data"

    def delta_data_path(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}.delta"

    def index_path(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}.index.json"

    def steps(self) -> list[int]:
        """Restorable steps, ascending: a manifest counts only when its
        ``step_NNN`` stem parses and its data file (``.data``, or
        ``.delta`` for a delta step) exists, so a torn save is never a
        resume candidate."""
        out = []
        for p in self.hdfs.listdir(self.base):
            name = p.rsplit("/", 1)[-1]
            if not (name.startswith("step_")
                    and name.endswith(".index.json")):
                continue
            stem = name[len("step_"):-len(".index.json")]
            if not stem.isdigit():
                continue
            step = int(stem)
            if (self.hdfs.exists(self.data_path(step))
                    or self.hdfs.exists(self.delta_data_path(step))):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ----- save -----

    def _index(self, step: int, trees: tuple, meta: Optional[dict],
               hash_chunk: int) -> tuple[TensorIndex, list[torch.Tensor]]:
        """The manifest of ``trees`` without its chunk hashes, and the
        leaves in stream order."""
        index = TensorIndex(meta=dict(meta or {}, step=step,
                                      n_trees=len(trees)))
        index.hash_chunk = hash_chunk
        leaves = []
        for ti, tree in enumerate(trees):
            for name, leaf in flat_with_names(tree):
                if not isinstance(leaf, torch.Tensor):
                    raise TypeError(f"checkpoint: t{ti}{name} is "
                                    f"{type(leaf).__name__}, not a tensor")
                suffix, dtype = _stored(leaf)
                index.add(f"t{ti}{name}{suffix}", dtype, leaf.shape)
                leaves.append(leaf)
        return index, leaves

    def _writer(self, path: str):
        if self.striped:
            return StripedWriter(self.hdfs, path, width=self.width,
                                 threads=self.threads,
                                 placement=self.placement, chunk=self.chunk,
                                 stripe=self.stripe)
        return _PlainWriter(self.hdfs, path)

    def _piece_bytes(self, hash_chunk: int) -> int:
        return max(hash_chunk, PIECE_BYTES // hash_chunk * hash_chunk)

    @_gathered_on_rank0
    def save(self, step: int, *trees: Any,
             meta: Optional[dict] = None) -> TensorIndex:
        """A full snapshot of ``trees`` (params first) as step ``step``,
        with chunk CRCs for later deltas; the manifest is written last, so
        a torn save leaves no restorable step."""
        t0 = time.perf_counter()
        index, leaves = self._index(step, trees, meta, self.diff_chunk)
        staging = _Staging(self._piece_bytes(self.diff_chunk))
        entries = index.entries_by_offset()
        write_s = crc_wait_s = 0.0
        if index.total_bytes == 0:
            self.hdfs.write(self.data_path(step), b"")
        else:
            with self._writer(self.data_path(step)) as w:
                for e, leaf in zip(entries, leaves):
                    crcs = index.chunk_hashes[e.name] = []
                    for piece in staging.pieces(leaf):
                        futs = _chunk_crcs(piece, self.diff_chunk)
                        t1 = time.perf_counter()
                        w.write(piece)
                        t2 = time.perf_counter()
                        crcs += _gather(futs)
                        write_s += t2 - t1
                        crc_wait_s += time.perf_counter() - t2
                t1 = time.perf_counter()
            write_s += time.perf_counter() - t1   # the last chunk, files closed
        self.hdfs.write(self.index_path(step), index.to_json().encode())
        self.timings = {"save_bytes": index.total_bytes,
                        "save_s": time.perf_counter() - t0,
                        "save_copy_s": staging.copy_s,
                        "save_write_s": write_s,
                        "save_crc_wait_s": crc_wait_s}
        return index

    @_gathered_on_rank0
    def save_delta(self, step: int, *trees: Any, base: Optional[int] = None,
                   meta: Optional[dict] = None) -> TensorIndex:
        """Incremental save: only the byte ranges of ``trees`` whose chunk
        CRCs differ from step ``base``'s manifest (default: the latest
        restorable step) are written; the base data is never read.
        ``trees`` must be congruent to the base's. A first pass hashes
        every leaf, a second copies only the changed ranges."""
        t0 = time.perf_counter()
        if base is None:
            base = self.latest_step()
            if base is None:
                raise ValueError(
                    "save_delta: no base snapshot to diff against — write "
                    "a full save() first")
        base_index = self.load_index(base)
        if base_index.hash_chunk is None:
            raise ValueError(
                f"save_delta: base step {base} has no chunk hashes "
                "(pre-delta checkpoint) — re-save it full first")
        chunk = base_index.hash_chunk
        index, leaves = self._index(step, trees, meta, chunk)
        mine = [(e.name, e.dtype, e.shape, e.offset)
                for e in index.entries_by_offset()]
        theirs = [(e.name, e.dtype, e.shape, e.offset)
                  for e in base_index.entries_by_offset()]
        if mine != theirs:
            raise ValueError(
                f"save_delta: trees are not congruent to base step {base} "
                "(names/dtypes/shapes must match) — write a full save() "
                "instead")
        staging = _Staging(self._piece_bytes(chunk))
        entries = index.entries_by_offset()
        for e, leaf in zip(entries, leaves):
            crcs = index.chunk_hashes[e.name] = []
            for piece in staging.pieces(leaf):
                crcs += _gather(_chunk_crcs(piece, chunk))
        ranges: list[tuple[int, int, int]] = []  # (logical, len, delta_off)
        delta_off = 0
        writer = None
        try:
            for e, leaf in zip(entries, leaves):
                old = base_index.chunk_hashes.get(e.name, [])
                for lo, ln in _changed(index.chunk_hashes[e.name], old,
                                       chunk, e.nbytes):
                    ranges.append((e.offset + lo, ln, delta_off))
                    delta_off += ln
                    if writer is None:
                        writer = self._writer(self.delta_data_path(step))
                    for piece in staging.pieces(leaf, lo, lo + ln):
                        writer.write(piece)
        finally:
            if writer is not None:
                writer.close()
        if writer is None:  # nothing changed: an empty plain file
            self.hdfs.write(self.delta_data_path(step), b"")
        index.delta = {"base_step": int(base), "ranges": ranges,
                       "data_bytes": delta_off}
        self.hdfs.write(self.index_path(step), index.to_json().encode())
        self.timings = {"save_bytes": delta_off,
                        "save_s": time.perf_counter() - t0}
        return index

    # ----- restore -----

    def load_index(self, step: int, *, sched=None,
                   priority: int = CRITICAL) -> TensorIndex:
        """Read the manifest for ``step``; with ``sched`` the read holds a
        "dfs" slot at ``priority`` and its bytes are accounted there."""
        if sched is None:
            raw = self.hdfs.read(self.index_path(step))
        else:
            with sched.slot("dfs", priority=priority):
                raw = self.hdfs.read(self.index_path(step))
            sched.account("dfs", priority, len(raw))
        return TensorIndex.from_json(raw.decode())

    def _file_reader(self, path: str, *, sched=None, priority: int = 0):
        if "striped" in self.hdfs.attrs(path):
            return StripedReader(self.hdfs, path, threads=self.threads,
                                 sched=sched, priority=priority)
        return _PlainReader(self.hdfs, path, sched=sched, priority=priority)

    def _delta_chain(self, step: int, index: Optional[TensorIndex] = None,
                     sched=None) -> list:
        """``[(step, index), ...]`` along ``step``'s delta chain, base
        first. Raises on a cycle."""
        chain = []
        seen: set[int] = set()
        cur, idx = step, (index if index is not None
                          else self.load_index(step, sched=sched))
        while True:
            if cur in seen:
                raise ValueError(f"delta chain cycle at step {cur}")
            seen.add(cur)
            chain.append((cur, idx))
            if not idx.is_delta:
                break
            cur = idx.base_step
            idx = self.load_index(cur, sched=sched)
        chain.reverse()
        return chain

    def _reader(self, step: int, *, sched=None, priority: int = 0,
                index: Optional[TensorIndex] = None):
        """Range reader for ``step``'s data stream: the file's own for a
        full step, a ``LayeredReader`` over the chain for a delta step."""
        if self.hdfs.exists(self.data_path(step)):
            return self._file_reader(self.data_path(step), sched=sched,
                                     priority=priority)
        chain = self._delta_chain(step, index=index, sched=sched)
        base_step, base_index = chain[0]
        if not self.hdfs.exists(self.data_path(base_step)):
            raise FileNotFoundError(
                f"checkpoint step {step}: base snapshot {base_step} data "
                "file is missing (torn or garbage-collected save)")
        readers = [self._file_reader(self.data_path(base_step),
                                     sched=sched, priority=priority)]
        layer_ranges = []
        for s, idx in chain[1:]:
            readers.append(self._file_reader(self.delta_data_path(s),
                                             sched=sched, priority=priority))
            layer_ranges.append(idx.delta["ranges"])
        total = base_index.total_bytes
        return LayeredReader(readers, build_layer_map(total, layer_ranges),
                             total)

    def _dim_slices(self, index: TensorIndex, likes: tuple, *, specs=None,
                    axis_sizes=None, coords=None,
                    shard_slices: Optional[dict] = None) -> dict:
        """{entry name: per-dim (start, size)} for this host. ``specs``
        are trees of PartitionSpec-like sequences (``None``: replicated)
        congruent to ``likes``, read against ``axis_sizes`` and
        ``coords`` (plain dicts): this host's slice of each entry."""
        out: dict = {}
        for name, rows in (shard_slices or {}).items():
            try:
                e = index.resolve(name)
            except KeyError:
                continue
            if len(e.shape) >= 1:
                out[e.name] = (tuple(rows),)
        if specs is None:
            return out
        sizes = dict(axis_sizes or {})
        for ti, spec_tree in enumerate(specs):
            if spec_tree is None or ti >= len(likes):
                continue
            for name, spec in _flat_specs(spec_tree):
                if spec is None:
                    continue
                try:
                    e = index.resolve(f"t{ti}{name}")
                except KeyError:
                    continue
                out[e.name] = dim_slices_for_spec(spec, e.shape, sizes,
                                                  dict(coords or {}))
        return out

    @staticmethod
    def _wave_names(index: TensorIndex, n_likes: int) -> list:
        """Entry names per wave, in stream order: tree 0 (params), then
        the other trees asked for (optimizer state). Trees past ``likes``
        are not planned: restoring the params of a training checkpoint
        reads 13.59 of its 40.77 GB for qwen2.5-3b (the reference plans
        every tree into one wave when given one, and drops the rest)."""
        def tree(name: str) -> int:
            return int(re.match(r"t(\d+)", name).group(1))

        order = [e.name for e in index.entries_by_offset()
                 if tree(e.name) < max(n_likes, 1)]
        waves = ([n for n in order if tree(n) == 0],
                 [n for n in order if tree(n) > 0])
        return [w for w in waves if w]

    def plan_restore(self, step: int, *likes: Any, specs=None,
                     axis_sizes=None, coords=None,
                     shard_slices: Optional[dict] = None, sched=None,
                     **plan_kw) -> tuple[TensorIndex, list[RestorePlan]]:
        """This host's restore plan for ``step``: one ``RestorePlan`` per
        wave (params, then optimizer state). Likes of DTensors default
        ``specs`` to their placements, ``axis_sizes`` to their mesh's and
        ``coords`` to this rank's coordinates on it."""
        mesh_likes = [leaf for like in likes
                      for _, leaf in flat_with_names(like)
                      if _is_dtensor(leaf)]
        if mesh_likes:
            mesh = mesh_likes[0].device_mesh
            if specs is None:
                specs = tuple(_spec_tree(like) for like in likes)
            if axis_sizes is None:
                axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            if coords is None:
                coords = dict(zip(mesh.mesh_dim_names,
                                  mesh.get_coordinate()))
        index = self.load_index(step, sched=sched)
        slices = self._dim_slices(index, likes, specs=specs,
                                  axis_sizes=axis_sizes, coords=coords,
                                  shard_slices=shard_slices)
        plans = [build_restore_plan(index, names, slices, **plan_kw)
                 for names in self._wave_names(index, len(likes))]
        return index, plans

    def _restore_wave(self, reader, plan: RestorePlan, priority: int,
                      device: torch.device, times: Optional[dict]) -> dict:
        """{entry name: tensor on ``device``} (stored dtype, shard shape)
        for one wave, read by ``pread_many`` in groups of at most one ring
        slot. On the CPU contiguous reads land in the tensors directly and
        gap-coalesced ones scatter from scratch. On a card every read
        lands, zero copy, in a ring of ``RING_SLOTS`` pinned buffers, and
        each group is copied on to the card while the next one is read;
        only the ring is page-locked (page-locking a tensor-sized buffer
        per tensor took 5.41 of wave 0's 6.03 s for qwen2.5-3b). The
        copies are not waited for here. Spans ``ckpt.alloc`` (the device
        buffers and the ring) and ``ckpt.read`` (each group's reads),
        whose seconds it adds to ``times`` as ``alloc_s`` and ``read_s``
        when given."""
        cuda = device.type == "cuda"
        slot_bytes = max([RING_BYTES] + [op.length for op in plan.reads])
        with span("ckpt.alloc", times, "alloc_s"):
            bufs = [torch.empty(t.nbytes, dtype=torch.uint8, device=device)
                    for t in plan.tensors]
            ring = [torch.empty(slot_bytes, dtype=torch.uint8,
                                pin_memory=True)
                    for _ in range(RING_SLOTS if cuda else 0)]
        landed: list = [None] * RING_SLOTS   # a slot's copies, recorded
        groups: list[list] = [[]]
        for op in plan.reads:
            if groups[-1] and sum(o.length for o in groups[-1]) + \
                    op.length > slot_bytes:
                groups.append([])
            groups[-1].append(op)
        for k, ops in enumerate(g for g in groups if g):
            into = []
            if cuda:
                slot = k % RING_SLOTS
                if landed[slot] is not None:
                    landed[slot].synchronize()   # its copies have read it
                at = 0
                for op in ops:
                    into.append(ring[slot][at:at + op.length])
                    at += op.length
            else:
                for op in ops:
                    s = op.segments[0]
                    into.append(bufs[s.tensor][s.dest_off:s.dest_off + s.length]
                                if op.contiguous
                                else torch.empty(op.length, dtype=torch.uint8))
            with span("ckpt.read", times, "read_s"):
                _checked_pread_many(reader,
                                    [(op.offset, op.length) for op in ops],
                                    [t.numpy() for t in into],
                                    priority=priority)
            for op, src in zip(ops, into):
                if cuda or not op.contiguous:
                    for s in op.segments:
                        bufs[s.tensor][s.dest_off:s.dest_off + s.length].copy_(
                            src[s.src_off:s.src_off + s.length],
                            non_blocking=cuda)
            if cuda:
                landed[slot] = torch.cuda.Event()
                landed[slot].record()
        out = {}
        for t, buf in zip(plan.tensors, bufs):
            dtype = (torch.bfloat16 if t.name.endswith("#bf16")
                     else _NUMPY_TO_TORCH[np.dtype(t.dtype).name])
            out[t.name] = buf.view(dtype).reshape(t.shape)
        return out

    @staticmethod
    def _wait(device: torch.device, times: Optional[dict]) -> None:
        """Waits for a wave's copies to the card, a ``ckpt.copy_wait``
        span; adds the seconds waited after its last read to ``times`` as
        ``copy_s`` when given."""
        if device.type == "cuda":
            with span("ckpt.copy_wait", times, "copy_s"):
                torch.cuda.current_stream(device).synchronize()

    @staticmethod
    def _assemble(likes: tuple, first_ti: int, results: dict,
                  sliced: set) -> list:
        """Trees shaped like ``likes`` of the restored tensors; a tensor
        restored whole must have its like's shape."""
        out = []
        for k, like in enumerate(likes):
            leaves = []
            for name, leaf in flat_with_names(like):
                key = f"t{first_ti + k}{name}"
                t = results.get(key, results.get(key + "#bf16"))
                if t is None:
                    raise KeyError(f"restore: missing tensor {key}")
                shape = getattr(leaf, "shape", None)
                if (shape is not None and key not in sliced
                        and key + "#bf16" not in sliced
                        and tuple(shape) != tuple(t.shape)):
                    raise ValueError(f"restore: {key} has shape "
                                     f"{tuple(t.shape)} in the checkpoint, "
                                     f"{tuple(shape)} in the tree")
                if _is_dtensor(leaf):
                    from torch.distributed.tensor import DTensor
                    t = DTensor.from_local(
                        t, leaf.device_mesh, leaf.placements,
                        run_check=False, shape=leaf.shape,
                        stride=leaf.stride())
                leaves.append(t)
            out.append(_unflatten(like, iter(leaves)))
        return out

    def restore_planned(self, step: int, *likes: Any, specs=None,
                        axis_sizes=None, coords=None,
                        shard_slices: Optional[dict] = None,
                        async_tail: bool = False, sched=None,
                        priority: int = CRITICAL,
                        tail_priority: int = DEFERRED,
                        device: torch.device | str = "cpu", **plan_kw):
        """Planner-backed restore of trees congruent to ``likes`` (trees of
        tensors, meta tensors included: only names and shapes are read),
        onto ``device`` in the stored dtypes.

        Returns ``tuple(trees)`` — or, with ``async_tail=True``, the pair
        ``(first_tree, Future)`` whose Future resolves to the tuple of the
        remaining trees, streamed on a background pool. ``sched`` meters
        every read: wave 0 at ``priority``, the tail at ``tail_priority``
        (the reference reads a synchronous tail at ``priority``).
        ``timings`` then holds ``wave0_read_s``, ``wave0_copy_s``,
        ``wave0_bytes`` and, once the tail is done, ``tail_s`` and
        ``tail_bytes``.

        Trees of DTensors (``Model.init_like`` on a mesh): by default each
        leaf's placements are its spec, against its mesh's sizes and this
        rank's coordinates, so the rank plans and reads only its slices;
        each comes back as a DTensor with the like's placements."""
        device = torch.device(device)
        index, plans = self.plan_restore(
            step, *likes, specs=specs, axis_sizes=axis_sizes, coords=coords,
            shard_slices=shard_slices, sched=sched, **plan_kw)
        sliced = {t.name for p in plans for t in p.tensors
                  if t.shape != index.entries[t.name].shape}
        reader = self._reader(step, sched=sched, priority=priority,
                              index=index)
        times = self.timings = {}
        wave0: dict = {"bytes": plans[0].payload_bytes if plans else 0}
        results = (self._restore_wave(reader, plans[0], priority, device,
                                      wave0) if plans else {})

        def tail(prio: int) -> dict:
            with span("ckpt.tail", times, "tail_s"):
                res: dict = {}
                for plan in plans[1:]:
                    res.update(self._restore_wave(reader, plan, prio,
                                                  device, None))
                self._wait(device, None)
            times["tail_bytes"] = sum(p.payload_bytes for p in plans[1:])
            return res

        # the tail starts reading while wave 0's last copies land, its
        # spans in the caller's trace
        fut: Optional[Future] = None
        if async_tail and len(likes) > 1:
            fut = _pool("tail").submit(
                contextvars.copy_context().run,
                lambda: tuple(self._assemble(likes[1:], 1,
                                             tail(tail_priority), sliced)))
        self._wait(device, wave0)
        times.update({f"wave0_{k}": v for k, v in wave0.items()})
        if not async_tail:
            results.update(tail(priority))
            return tuple(self._assemble(likes, 0, results, sliced))
        first = self._assemble(likes[:1], 0, results, sliced)[0]
        if fut is None:
            fut = Future()
            fut.set_result(())
        return first, fut

    def restore(self, step: int, *likes: Any,
                shard_slices: Optional[dict] = None, sched=None,
                priority: int = CRITICAL,
                device: torch.device | str = "cpu") -> tuple:
        """Restore trees congruent to ``likes``; ``shard_slices``
        ({name: (start_row, n_rows)}) restores leading-dim row shards."""
        return self.restore_planned(step, *likes, shard_slices=shard_slices,
                                    sched=sched, priority=priority,
                                    device=device)

    def restore_bytes_for_shard(self, step: int, fraction: float, *,
                                specs=None, rules=None, axis_sizes=None,
                                coords=None,
                                shard_slices: Optional[dict] = None) -> int:
        """Planned bytes for a host reading ``fraction`` of every sharded
        entry of ``step``: sharded entries count at ``fraction``, the rest
        (read whole by every host) at 1. Which entries are sharded comes
        from ``specs`` (against ``axis_sizes``, or ``rules``' sizes) or
        ``shard_slices``, as ``plan_restore`` reads them; with neither,
        every entry but a scalar is taken as sharded. The reference's
        method of the same name."""
        index = self.load_index(step)
        if rules is not None and not axis_sizes:
            axis_sizes = rules.axis_sizes
        likes = (None,) * len(specs) if specs is not None else ()
        sliced = self._dim_slices(index, likes, specs=specs,
                                  axis_sizes=axis_sizes, coords=coords,
                                  shard_slices=shard_slices)
        have_info = specs is not None or shard_slices
        total = 0.0
        for e in index.entries.values():
            if e.name in sliced or (not have_info and e.shape):
                total += e.nbytes * fraction
            else:
                total += e.nbytes
        return int(total)


class _PlainWriter:
    """A non-striped data file, gathered and written whole (the
    reference's ``striped=False`` layout)."""

    def __init__(self, hdfs: HdfsCluster, path: str):
        self.hdfs, self.path = hdfs, path
        self._buf = bytearray()

    def write(self, data) -> None:
        self._buf += data

    def close(self) -> None:
        self.hdfs.write(self.path, bytes(self._buf))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _changed(new: list[int], old: list[int], chunk: int,
             nbytes: int) -> Iterator[tuple[int, int]]:
    """``delta.changed_ranges`` from chunk CRCs already taken: coalesced
    (offset, length) ranges, within one entry, of the chunks whose CRC
    differs from ``old`` (chunks past its end count as changed)."""
    cur: Optional[list] = None
    for ci, crc in enumerate(new):
        lo, hi = ci * chunk, min((ci + 1) * chunk, nbytes)
        if ci < len(old) and crc == old[ci]:
            if cur is not None:
                yield cur[0], cur[1] - cur[0]
                cur = None
        elif cur is not None and cur[1] == lo:
            cur[1] = hi
        else:
            if cur is not None:
                yield cur[0], cur[1] - cur[0]
            cur = [lo, hi]
    if cur is not None:
        yield cur[0], cur[1] - cur[0]
