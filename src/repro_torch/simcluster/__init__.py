"""The discrete-event twin of a cluster's startup, the port of the JAX
package's ``simcluster/``: the same model, defaults and seeds (numpy
only), so its scale curves equal the reference's bit for bit."""

from repro_torch.simcluster.resources import FluidResource, Transfer, simulate_stage  # noqa: F401
from repro_torch.simcluster.workload import StartupWorkload, ClusterParams  # noqa: F401
from repro_torch.simcluster.trace import generate_cluster_trace  # noqa: F401
