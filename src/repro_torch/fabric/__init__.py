"""The storage fabric: shared node caching, placement and erasure coding
for every BootSeer storage consumer (blockstore, envcache, striped DFS),
copies of the JAX package's ``fabric/``.

See repro_torch.fabric.cache (NodeCache + eviction policies),
repro_torch.fabric.placement (striped / replicated / erasure strategies),
repro_torch.fabric.federation (cross-region hot-block replication) and
repro_torch.fabric.gf256 (the Reed-Solomon kernel).
"""

from repro_torch.fabric.cache import (EvictionPolicy, HotScorePolicy,
                                      LRUPolicy, NodeCache)
from repro_torch.fabric.federation import RegionReplicator
from repro_torch.fabric.gf256 import rs_decode, rs_encode
from repro_torch.fabric.placement import ERASURE, REPLICATED, STRIPED, Placement

__all__ = [
    "EvictionPolicy", "HotScorePolicy", "LRUPolicy", "NodeCache",
    "Placement", "STRIPED", "REPLICATED", "ERASURE",
    "RegionReplicator",
    "rs_encode", "rs_decode",
]
