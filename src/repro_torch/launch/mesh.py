"""Production mesh builders, the counterpart of the JAX package's
``launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group. ``torch.distributed`` must be initialised with as many
ranks as the mesh has devices; the dry run (``launch/dryrun.py``) gives it
a ``"fake"`` group of 256 or 512 ranks and builds the meshes on the
``"meta"`` device.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 devices per pod; 2 pods = 512 devices when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cuda"):
    """A one-device mesh with the production axis names."""
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
