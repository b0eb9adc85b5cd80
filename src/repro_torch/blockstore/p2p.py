"""Peer-to-peer block sharing between a job's worker nodes (§4.2).

The engine lives in :mod:`repro_torch.blockstore.swarm`; this module keeps the
original ``PeerGroup`` name as a single-tier configuration of it.  Two seed
bugs died in the rebuild:

* waiters whose wait timed out (or whose fetcher-of-record failed) used to
  fall back to the registry with no singleflight marker — N-1 nodes
  stampeded the source after one slow fetch.  ``Swarm.fetch`` re-arms the
  in-flight marker on fallback (one waiter takes over; retries capped).
* per-peer accounting was keyed by ``node_id``, so two clients on one node
  (multi-image startups) silently clobbered each other's served-bytes
  stats and skewed least-loaded peer selection.  Stats are now keyed by
  client identity and duplicate identities are rejected.
"""

from __future__ import annotations

from repro_torch.blockstore.swarm import Swarm, Topology


class PeerGroup(Swarm):
    """A flat (single-rack) swarm — the seed API, swarm semantics."""

    def __init__(self, per_peer_throttle=None):
        super().__init__(
            Topology(rack_fn=lambda node_id: "rack0"),
            intra_rack=per_peer_throttle)
        self.per_peer_throttle = per_peer_throttle
