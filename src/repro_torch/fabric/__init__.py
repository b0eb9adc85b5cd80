"""The storage fabric's placement strategies and its Reed-Solomon kernel,
as the striped DFS uses them (copies of the JAX package's
``fabric/placement.py`` and ``fabric/gf256.py``). ``NodeCache`` and
``RegionReplicator`` come with the startup half (ROADMAP.md A.2).
"""

from repro_torch.fabric.gf256 import rs_decode, rs_encode
from repro_torch.fabric.placement import ERASURE, REPLICATED, STRIPED, Placement

__all__ = ["Placement", "STRIPED", "REPLICATED", "ERASURE",
           "rs_encode", "rs_decode"]
