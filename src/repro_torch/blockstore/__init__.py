from repro_torch.blockstore.image import build_image, ImageManifest  # noqa: F401
from repro_torch.blockstore.registry import Registry  # noqa: F401
from repro_torch.blockstore.lazy import LazyImageClient  # noqa: F401
from repro_torch.blockstore.prefetch import HotBlockService, prefetch_image  # noqa: F401
from repro_torch.blockstore.p2p import PeerGroup  # noqa: F401
from repro_torch.blockstore.swarm import Swarm, Topology  # noqa: F401
