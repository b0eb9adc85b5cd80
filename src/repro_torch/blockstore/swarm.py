"""Swarm-scale peer-to-peer block distribution (§4.2 at cluster scale).

The seed ``PeerGroup`` scanned every peer under one global lock and assumed
one job pulling one image — exactly the shape that collapses back into the
§3.4 registry stampede at 1,000+ concurrent pulls.  This module replaces it
with a topology-aware swarm:

* **Sharded availability index** — block hash -> holder set, spread over
  lock stripes: index lookups and singleflight markers never take a
  global lock and never scan the peer list (per-serve load accounting
  uses a small dedicated stats lock, off the index path).
* **Singleflight with re-arm** — concurrent requests for one block coalesce
  behind a fetcher-of-record; if that fetcher fails or stalls, exactly ONE
  waiter re-arms the in-flight marker and takes over (the rest keep
  waiting), so a failure costs one extra registry fetch, not N-1.
* **Bounded dissemination tree** — each holder serves at most
  ``serve_slots`` concurrent uploads.  Waiters woken by a publish fan out
  over the (growing) holder set, so a cold block reaches N nodes through a
  tree of bounded degree: registry egress is O(unique blocks), per-peer
  upload load is O(serve_slots).
* **Region/rack/node tiers** — a :class:`Topology` maps nodes to racks
  and racks to regions; serving prefers same-rack, then same-region,
  then cross-region holders, and per-link :class:`ThrottleModel`s meter
  intra-rack vs cross-rack vs cross-region (WAN) traffic separately.
  After the FIRST cross-region pull of a block, every later fetch in
  that region is rack- or region-local — the federation property
  ``repro_torch.fabric.federation`` builds on.
* **Many jobs / images per node** — membership and accounting are keyed by
  *client identity* (node + image digest), not node id, and blocks are
  content-addressed, so concurrent jobs share one swarm (and dedup blocks
  across images) without clobbering each other's stats.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional


def _client_id(client) -> str:
    cid = getattr(client, "client_id", None)
    return cid if cid is not None else client.node_id


def _ewma(prev: float, sample: float, alpha: float) -> float:
    """Exponentially-weighted moving average; 0.0 means "no samples yet"
    (serve latencies are strictly positive), so the first sample seeds."""
    return sample if prev == 0.0 else (1 - alpha) * prev + alpha * sample


@dataclass
class Topology:
    """Node -> rack -> region mapping with overridable assignment rules.

    Racks: ``racks`` pins specific node ids; otherwise the trailing
    integer of the LOCAL part of the node id (``node0042`` -> 42,
    ``eu-node0042`` -> 42) is grouped ``nodes_per_rack`` at a time.
    Node ids without a trailing integer hash deterministically into
    ``hash_racks`` buckets.  Rack names are region-qualified
    (``eu/rack5``) whenever the node's region differs from
    ``default_region`` — so ``node0042`` and ``eu-node0042`` can never
    collide into one rack even though they share a trailing integer.

    Regions (the tier above racks): ``regions`` pins node ids,
    ``region_fn`` overrides the rule, otherwise a ``region-`` prefix
    before the first ``-`` names the region (``eu-node0042`` -> ``eu``).
    Unprefixed ids hash into ``hash_regions`` buckets when
    ``hash_regions > 1``, else land in ``default_region`` — the
    single-region default, under which every pre-region node id keeps
    its exact historical rack name.  Deployments with other naming
    should pass ``racks``/``regions`` or ``rack_fn``/``region_fn``.
    """

    nodes_per_rack: int = 8
    racks: dict = field(default_factory=dict)      # node_id -> rack name
    rack_fn: Optional[Callable[[str], str]] = None
    hash_racks: int = 16
    regions: dict = field(default_factory=dict)    # node_id -> region name
    region_fn: Optional[Callable[[str], str]] = None
    hash_regions: int = 1
    default_region: str = "region0"

    @staticmethod
    def _split(node_id: str) -> tuple[Optional[str], str]:
        """(region prefix or None, local part) for ``<region>-<local>``
        ids; ids without a usable prefix are all-local."""
        prefix, sep, rest = node_id.partition("-")
        if sep and prefix and rest:
            return prefix, rest
        return None, node_id

    def region_of(self, node_id: str) -> str:
        if node_id in self.regions:
            return self.regions[node_id]
        if self.region_fn is not None:
            return self.region_fn(node_id)
        prefix, _local = self._split(node_id)
        if prefix is not None:
            return prefix
        if self.hash_regions > 1:
            return (f"region"
                    f"{zlib.crc32(node_id.encode()) % self.hash_regions}")
        return self.default_region

    def rack_of(self, node_id: str) -> str:
        if node_id in self.racks:
            return self.racks[node_id]
        if self.rack_fn is not None:
            return self.rack_fn(node_id)
        region = self.region_of(node_id)
        _prefix, local = self._split(node_id)
        digits = ""
        for ch in reversed(local):
            if ch.isdigit():
                digits = ch + digits
            elif digits:
                break
        if digits:
            base = f"rack{int(digits) // max(self.nodes_per_rack, 1)}"
        else:
            base = f"rack{zlib.crc32(local.encode()) % self.hash_racks}"
        # region-qualify so same-numbered racks in different regions are
        # distinct link tiers; the default region keeps bare names (every
        # pre-region deployment keeps its exact rack assignment)
        return base if region == self.default_region else f"{region}/{base}"


class _Flight:
    __slots__ = ("event", "owner")

    def __init__(self, owner: str):
        self.event = threading.Event()
        self.owner = owner


class _Shard:
    __slots__ = ("lock", "holders", "inflight", "wan_inflight")

    def __init__(self):
        self.lock = threading.Lock()
        self.holders: dict[str, set[str]] = {}   # block hash -> client ids
        self.inflight: dict[str, _Flight] = {}
        # (block hash, region) -> flight: at most ONE cross-region pull
        # of a block per destination region (WAN singleflight)
        self.wan_inflight: dict[tuple[str, str], _Flight] = {}


class Swarm:
    """Topology-aware block swarm shared by many jobs and images.

    Parameters
    ----------
    topology: rack/node tier map (defaults to one flat rack group per 8
        nodes).
    serve_slots: max concurrent uploads per holder — the dissemination
        tree's fan-out bound.
    wait_timeout / max_wait_rounds: how long a coalesced waiter parks per
        round and how many rounds before it gives up and goes to the
        registry itself (the capped worst case).
    nshards: lock stripes for the availability index.
    intra_rack / cross_rack / cross_region: optional ``ThrottleModel``s
        charged per served block on the corresponding link tier.
        ``cross_region`` may also be a dict mapping
        ``frozenset({region_a, region_b})`` -> ``ThrottleModel`` so each
        WAN region pair gets its own (asymmetric) link; pairs without an
        entry go unthrottled.
    """

    def __init__(self, topology: Optional[Topology] = None, *,
                 serve_slots: int = 4, wait_timeout: float = 10.0,
                 max_wait_rounds: int = 3, nshards: int = 16,
                 intra_rack=None, cross_rack=None, cross_region=None,
                 latency_alpha: float = 0.3):
        self.topology = topology or Topology()
        self.serve_slots = serve_slots
        self.wait_timeout = wait_timeout
        self.max_wait_rounds = max_wait_rounds
        # EWMA smoothing for observed per-peer serve latency (0 < a <= 1;
        # higher = reacts faster to a peer going slow)
        if not 0.0 < latency_alpha <= 1.0:
            raise ValueError(
                f"latency_alpha must be in (0, 1], got {latency_alpha}")
        self.latency_alpha = latency_alpha
        self._shards = [_Shard() for _ in range(max(nshards, 1))]
        self._meta = threading.Lock()            # membership only
        self._stats = threading.Lock()           # per-serve accounting
        self._counters = threading.Lock()        # rare coalesce/rearm ticks
        self._clients: dict[str, object] = {}
        self._racks: dict[str, str] = {}         # client_id -> rack
        self._regions: dict[str, str] = {}       # client_id -> region
        self._sems: dict[str, threading.Semaphore] = {}
        # client_id -> {"blocks_served", "bytes_served", "active_serves",
        #               "serve_latency_ewma_s"}
        self.stats: dict[str, dict] = {}
        self.link_stats = {
            "intra_rack": {"blocks": 0, "bytes": 0,
                           "serve_latency_ewma_s": 0.0},
            "cross_rack": {"blocks": 0, "bytes": 0,
                           "serve_latency_ewma_s": 0.0},
            "cross_region": {"blocks": 0, "bytes": 0,
                             "serve_latency_ewma_s": 0.0},
        }
        # WAN ingress per DESTINATION region: how many bytes each region
        # imported over cross-region links — with federation working,
        # this converges to ~1.0x the unique bytes the region needed
        self.region_ingress: dict[str, dict] = {}
        self.coalesced_fetches = 0
        self.rearmed_fetches = 0
        self.wan_coalesced_fetches = 0
        self._throttles = {"intra_rack": intra_rack,
                           "cross_rack": cross_rack,
                           "cross_region": cross_region}

    # ----- membership -------------------------------------------------

    def join(self, client, *, replace: bool = False):
        """Register ``client`` (anything exposing ``node_id``,
        ``get_cached_block`` and optionally ``client_id`` /
        ``cached_hashes``).  Duplicate identities are rejected unless
        ``replace=True`` (warm restarts re-register the same identity)."""
        cid = _client_id(client)
        with self._meta:
            if cid in self._clients and not replace:
                raise ValueError(
                    f"duplicate swarm client identity {cid!r}: two clients "
                    "on one node must carry distinct client_ids (e.g. "
                    "distinct image digests) or join with replace=True")
            self._clients[cid] = client
            self._racks[cid] = self.topology.rack_of(client.node_id)
            self._regions[cid] = self.topology.region_of(client.node_id)
            self._sems.setdefault(cid, threading.Semaphore(self.serve_slots))
            self.stats.setdefault(cid, {"blocks_served": 0,
                                        "bytes_served": 0,
                                        "active_serves": 0,
                                        "serve_latency_ewma_s": 0.0})
        have = getattr(client, "cached_hashes", None)
        if have is not None:
            self.announce(client, have())

    def leave(self, client):
        cid = _client_id(client)
        with self._meta:
            self._clients.pop(cid, None)
            # drop the serve-slot semaphore too — leaving it behind
            # grows `_sems` by one entry per client identity ever seen
            # (a rejoin re-creates it in join(); in-progress serves hold
            # their own reference to the old object)
            self._sems.pop(cid, None)
        # holder-index entries are pruned lazily on the next failed pick

    def announce(self, client, hashes: Iterable[str]):
        """Add ``client`` as a holder of ``hashes`` (warm-cache seeding).

        Announcements are advisory: a block may vanish from the holder's
        disk afterwards (cache eviction, crash mid-publish) and the serve
        path tolerates that — a failed serve prunes the stale entry and
        the fetch falls through to the remaining holders, the
        singleflight marker, or the registry.  Holders with a bounded
        :class:`~repro_torch.fabric.cache.NodeCache` should ALSO withdraw
        eagerly via :meth:`withdraw` (the cache's eviction listener) so
        stale routing never happens in the first place."""
        cid = _client_id(client)
        for h in hashes:
            sh = self._shard(h)
            with sh.lock:
                sh.holders.setdefault(h, set()).add(cid)

    def withdraw(self, h: str, client):
        """Remove ``client`` as a holder of ``h`` — the eager inverse of
        :meth:`announce`, called when a block leaves a node's disk (cache
        eviction).  Accepts a client object or a bare client id."""
        cid = client if isinstance(client, str) else _client_id(client)
        self._drop_holder(h, cid)

    # ----- index ------------------------------------------------------

    def _shard(self, h: str) -> _Shard:
        return self._shards[zlib.crc32(h.encode()) % len(self._shards)]

    def holder_count(self, h: str) -> int:
        sh = self._shard(h)
        with sh.lock:
            return len(sh.holders.get(h, ()))

    def _region_snapshot(self) -> dict:
        """client_id -> region copy; taken under the membership lock and
        RELEASED before any shard lock (no lock nesting)."""
        with self._meta:
            return dict(self._regions)

    def region_holder_count(self, h: str, region: str) -> int:
        """How many live holders of ``h`` sit inside ``region`` — the
        replication-factor signal the federation layer tops up."""
        regions = self._region_snapshot()
        sh = self._shard(h)
        with sh.lock:
            return sum(1 for c in sh.holders.get(h, ())
                       if regions.get(c) == region)

    def rarest_first(self, hashes: Iterable[str],
                     requester=None) -> list[str]:
        """Order ``hashes`` by ascending holder count (stable within a
        rarity class), so dissemination maximizes swarm diversity.

        With a ``requester`` (client object, client id, or region name),
        ties in the GLOBAL count break on the requester-region-local
        holder count: among equally-rare blocks, the ones this region
        holds fewest copies of stream first, so each region organically
        builds its own replica set instead of re-crossing the WAN."""
        out = list(hashes)
        region = None
        if requester is not None:
            if isinstance(requester, str):
                region = self._regions.get(requester, requester)
            else:
                region = self._regions.get(_client_id(requester)) or \
                    self.topology.region_of(requester.node_id)
        if region is None:
            counts = {h: (self.holder_count(h),) for h in out}
        else:
            regions = self._region_snapshot()
            counts = {}
            for h in out:
                sh = self._shard(h)
                with sh.lock:
                    hs = sh.holders.get(h, ())
                    counts[h] = (len(hs),
                                 sum(1 for c in hs
                                     if regions.get(c) == region))
        out.sort(key=lambda h: counts[h])
        return out

    # ----- fetch hot path ---------------------------------------------

    def fetch(self, h: str, requester) -> Optional[bytes]:
        """Block payload served peer-to-peer, or ``None`` when the caller
        must fetch from the registry itself.  A ``None`` return normally
        means the caller is the fetcher-of-record and MUST call
        :meth:`publish` (success) or :meth:`abandon` (failure) once done;
        a waiter that exhausted ``max_wait_rounds`` also gets ``None`` but
        holds no marker."""
        cid = _client_id(requester)
        req_region = self._regions.get(cid)
        if req_region is None:
            req_region = self.topology.region_of(
                getattr(requester, "node_id", cid))
        sh = self._shard(h)
        parked = False
        wan_parked = False
        timeouts = 0
        while True:
            wan_wait = None
            with sh.lock:
                holders = [c for c in sh.holders.get(h, ()) if c != cid]
                ev = None
                if not holders:
                    fl = sh.inflight.get(h)
                    if fl is None:
                        # caller becomes the (re-armed) fetcher-of-record
                        sh.inflight[h] = _Flight(owner=cid)
                        if parked:
                            with self._counters:
                                self.rearmed_fetches += 1
                        return None
                    ev = fl.event
                    if not parked:
                        parked = True
                        with self._counters:
                            self.coalesced_fetches += 1
                elif timeouts <= self.max_wait_rounds and not any(
                        self._regions.get(c) == req_region
                        for c in holders):
                    # WAN singleflight: every live holder sits in another
                    # region, so this block would cross the WAN — coalesce
                    # to at most ONE puller per (block, region).  Everyone
                    # else parks until the puller publishes, then serves
                    # region-locally: a region-wide flash crowd costs one
                    # WAN transfer, not one per waiter.  A wedged puller
                    # is capped exactly like a wedged fetcher-of-record:
                    # past max_wait_rounds waiters stop deferring and
                    # pull cross-region themselves.
                    wfl = sh.wan_inflight.get((h, req_region))
                    if wfl is None:
                        sh.wan_inflight[(h, req_region)] = _Flight(
                            owner=cid)
                    elif wfl.owner != cid:
                        wan_wait = wfl.event
                        if not wan_parked:
                            wan_parked = True
                            with self._counters:
                                self.wan_coalesced_fetches += 1
            if wan_wait is not None:
                if not wan_wait.wait(timeout=self.wait_timeout):
                    timeouts += 1
                continue
            if holders:
                data = self._serve(h, holders, cid)
                if data is not None:
                    # a WAN puller keeps its marker until publish() (the
                    # block is on its way to disk; waiters would still
                    # only see cross-region holders) — the caller's
                    # publish clears it and wakes the region's waiters
                    return data
                self._wan_release(h, req_region, cid)
                continue  # stale holders pruned; re-evaluate
            if ev.wait(timeout=self.wait_timeout):
                # publish or abandon: re-check state — serve from the new
                # holder, park behind a re-armer's flight, or re-arm
                # ourselves.  Signaled wakes never count against the cap,
                # so a burst of failures wakes exactly one re-armer per
                # abandon instead of spilling every waiter to the registry.
                continue
            timeouts += 1
            if timeouts > self.max_wait_rounds:
                # the flight's owner is wedged (never published or
                # abandoned): give up on the swarm and go to the registry
                # directly — capped, and no marker is left dangling
                self._wan_release(h, req_region, cid)
                return None

    def _wan_release(self, h: str, region: str, cid: str):
        """Drop ``cid``'s WAN-singleflight marker for ``(h, region)`` (if
        it holds one) and wake the region's parked waiters."""
        sh = self._shard(h)
        with sh.lock:
            wfl = sh.wan_inflight.get((h, region))
            if wfl is None or wfl.owner != cid:
                return
            del sh.wan_inflight[(h, region)]
        wfl.event.set()

    def _link_tier(self, peer_id: str, req_rack, req_region) -> int:
        """0 = same rack, 1 = same region (cross-rack), 2 = cross-region.
        The tier order is ABSOLUTE: a cross-region holder is never picked
        while any live same-region holder remains."""
        if self._racks.get(peer_id) == req_rack:
            return 0
        if self._regions.get(peer_id) == req_region:
            return 1
        return 2

    _LINK_NAMES = ("intra_rack", "cross_rack", "cross_region")

    def _link_throttle(self, link: str, peer_region, req_region):
        """The ThrottleModel for one served block — ``cross_region`` may
        be a per-region-pair dict (each WAN link metered separately)."""
        t = self._throttles.get(link)
        if link == "cross_region" and isinstance(t, dict):
            return t.get(frozenset((peer_region, req_region)))
        return t

    def _serve(self, h: str, holder_ids: list[str], requester_id: str
               ) -> Optional[bytes]:
        req_rack = self._racks.get(requester_id)
        req_region = self._regions.get(requester_id)
        if req_region is None:
            # non-member requester (bare fetch caller): derive from id
            req_region = self.topology.region_of(requester_id)
        remaining = list(holder_ids)
        while remaining:
            # single O(H) min scan under the (serve-only) stats lock —
            # the fetch/index path never touches this lock.  Peer choice
            # is bandwidth-aware: same rack first, then same region,
            # then cross-region, and within a tier the least-loaded peer
            # with the LOWEST observed serve latency (EWMA) — a peer
            # that has gone slow (congested uplink, saturated WAN link,
            # busy disk) sheds load to faster holders instead of keeping
            # its byte-count-based share.  Fresh peers (no samples)
            # score 0 and get probed.
            with self._stats:
                def load(c):
                    st = self.stats.get(c, {})
                    return (self._link_tier(c, req_rack, req_region),
                            st.get("active_serves", 0),
                            st.get("serve_latency_ewma_s", 0.0),
                            st.get("bytes_served", 0))
                peer_id = min(remaining, key=load)
                remaining.remove(peer_id)
                peer = self._clients.get(peer_id)
                sem = self._sems.get(peer_id)
                if peer is not None:
                    self.stats[peer_id]["active_serves"] += 1
            if peer is None:
                self._drop_holder(h, peer_id)
                continue
            link = self._LINK_NAMES[
                self._link_tier(peer_id, req_rack, req_region)]
            peer_region = self._regions.get(peer_id)
            t0 = time.perf_counter()
            data = None
            try:
                with sem:
                    data = peer.get_cached_block(h)
                if data is not None:
                    # charge the link INSIDE the timed window: the EWMA
                    # sample must include the transfer cost, so a
                    # congested (throttled) link reads as high latency
                    # and the NEXT fetch's holder ranking sheds load off
                    # it — not just the disk-read time, which would make
                    # a saturated WAN link look as fast as a LAN one
                    throttle = self._link_throttle(link, peer_region,
                                                   req_region)
                    if throttle is not None:
                        with throttle:
                            throttle.charge(len(data))
            except OSError:
                self._drop_holder(h, peer_id)
            finally:
                serve_s = time.perf_counter() - t0
                with self._stats:
                    st = self.stats[peer_id]
                    # always decremented — any exception type must not
                    # leave the peer permanently "busy" in the shared
                    # runtime-level swarm
                    st["active_serves"] -= 1
                    if data is not None:
                        # only SUCCESSFUL serves feed the EWMA: an
                        # instant failure would read as "fast" and make
                        # a broken peer the most preferred holder of
                        # everything else it is indexed for
                        st["serve_latency_ewma_s"] = _ewma(
                            st.get("serve_latency_ewma_s", 0.0),
                            serve_s, self.latency_alpha)
            if data is None:
                continue
            with self._stats:
                self.stats[peer_id]["blocks_served"] += 1
                self.stats[peer_id]["bytes_served"] += len(data)
                ls = self.link_stats[link]
                ls["blocks"] += 1
                ls["bytes"] += len(data)
                ls["serve_latency_ewma_s"] = _ewma(
                    ls.get("serve_latency_ewma_s", 0.0), serve_s,
                    self.latency_alpha)
                if link == "cross_region":
                    ri = self.region_ingress.setdefault(
                        req_region, {"blocks": 0, "bytes": 0})
                    ri["blocks"] += 1
                    ri["bytes"] += len(data)
            return data
        return None

    def _drop_holder(self, h: str, cid: str):
        sh = self._shard(h)
        with sh.lock:
            hs = sh.holders.get(h)
            if hs is not None:
                hs.discard(cid)
                if not hs:
                    del sh.holders[h]

    # ----- publish / abandon ------------------------------------------

    def publish(self, h: str, client=None):
        """Mark ``h`` available on ``client`` and wake coalesced waiters.
        Clears any in-flight marker for ``h`` (the block exists now, so
        whoever owned the flight is moot) and, when the publisher's
        region is known, that region's WAN-singleflight marker — parked
        same-region waiters wake into a region-local serve."""
        region = None
        if client is not None:
            cid = _client_id(client)
            region = self._regions.get(cid) or self.topology.region_of(
                getattr(client, "node_id", cid))
        sh = self._shard(h)
        with sh.lock:
            if client is not None:
                sh.holders.setdefault(h, set()).add(cid)
            fl = sh.inflight.pop(h, None)
            wfl = (sh.wan_inflight.pop((h, region), None)
                   if region is not None else None)
        for f in (fl, wfl):
            if f is not None:
                f.event.set()

    def abandon(self, h: str, client):
        """The fetcher-of-record failed: clear its marker and wake waiters
        so exactly one of them re-arms and retries the registry.  Any
        WAN-singleflight marker the client holds is released too, so a
        region's parked waiters never hang on a failed puller."""
        cid = _client_id(client)
        region = self._regions.get(cid) or self.topology.region_of(
            getattr(client, "node_id", cid))
        self._wan_release(h, region, cid)
        sh = self._shard(h)
        with sh.lock:
            fl = sh.inflight.get(h)
            if fl is None or fl.owner != cid:
                return
            del sh.inflight[h]
        fl.event.set()
