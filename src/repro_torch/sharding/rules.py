"""Sharding rules: FSDP x TP (x pod) specs for every parameter family, the
counterpart of the JAX package's ``sharding/rules.py``.

Strategy, the reference's:
  * parameters: FSDP, the ``d_model`` dim over the data axes, feature and
    head-flattened dims over ``model`` (gathered over the data axes where
    they are used);
  * activations: batch over the data axes, feature dims over ``model``;
  * attention: sequence-sharded over ``model`` inside an island (head
    counts such as yi-34b's 56 do not divide a 16-way model axis; the
    sequence always does at the assigned shapes). Decode runs a
    distributed online softmax over the sequence-sharded KV cache;
  * MoE: an island, ``tp`` (hidden dim) or ``ep`` (expert dim) over
    ``model`` (``models/moe.py``);
  * multi-pod: the ``pod`` axis goes in front of the data axes, so the
    global batch shards over pod x data.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dim names
are the axis names. A spec is a tuple with one entry per tensor dim, as a
``PartitionSpec``'s: None (replicated), an axis name, or a tuple of axis
names (sharded over their product, the first the major one);
``placements(spec)`` turns it into DTensor placements. ``Rules(mesh=None)``
(``single_device_rules``) is one device: every axis has size 1, every spec
helper gives what the reference's (1, 1) mesh gives, and the model runs on
plain tensors, today's path.

Knobs. ``moe_sharding``, ``serving_layout``, ``seq_sharded_acts`` and
``param_gather_dtype`` are placements, or the point where a cast happens,
on the sharded path; ``remat`` recomputes each layer in the backward pass
on either path. ``q_chunk``, ``k_chunk`` and ``skip_masked_blocks`` shape
the reference's jnp scan; the port's attention runs the flash kernels,
which tile by their own launch configs and always skip masked tiles, so
they have no effect here. The two SSD knobs, as the reference's
``mamba_sublayer`` reads them:

  * ``ssd_compute_dtype`` ("float32" | "bfloat16") is the type of the
    scan's intra-chunk products. On the CPU the plain version casts C B^T,
    the decay matrix and x dt to it, as the reference does, the decays,
    the per-chunk states and the inter-chunk term staying fp32. On the
    card "bfloat16" launches the SSD kernels' bf16-intra instance: the
    intra-tile product M = (C B^T) exp(cs_i - cs_j) dt_j (and, backward,
    Q) fed to the tensor cores as one bf16 part instead of a hi + lo
    pair; the state and x w keep both parts, as the reference keeps them
    fp32. It does not repeat the reference's roundings bit for bit.
  * ``ssm_chunk`` (0: the config's ``chunk_size``) is the plain version's
    chunk, on the CPU and on the mesh. Like ``q_chunk`` / ``k_chunk`` it
    blocks the work and moves the result by rounding only; on the card it
    is not the kernel's tile, which its launch config resolves
    (``kernels/ops.py``'s ``ssd_config``), and the kernel still launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclass
class Rules:
    mesh: Optional[object]            # DeviceMesh, or None: one device
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    moe_sharding: str = "tp"          # "tp" | "ep"
    remat: bool = True                # activation checkpointing for train
    # the reference's attention scan blocks; no effect on the kernels
    q_chunk: int = 1024
    k_chunk: int = 1024
    skip_masked_blocks: bool = True
    # cast fp32 master params to bf16 BEFORE the FSDP gather, so the
    # gathers move half the bytes
    param_gather_dtype: str = "float32"     # "float32" | "bfloat16"
    # the SSD scan's intra-chunk products: the plain version's casts on the
    # CPU, the kernels' bf16-intra instance on the card
    ssd_compute_dtype: str = "float32"      # "float32" | "bfloat16"
    # the plain version's SSD chunk (0: the config's chunk_size); never the
    # kernel's tile
    ssm_chunk: int = 0
    # DECODE-ONLY serving layout: params pure-TP over BOTH mesh axes,
    # batch replicated across data, KV cache sequence dim over all axes
    serving_layout: bool = False
    # keep activations sequence-sharded over the model axis between layers
    seq_sharded_acts: bool = False

    def __post_init__(self):
        if self.moe_sharding not in ("tp", "ep"):
            raise ValueError(f"Rules: moe_sharding {self.moe_sharding!r}")
        if self.param_gather_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Rules: param_gather_dtype {self.param_gather_dtype!r}")
        if self.ssd_compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Rules: ssd_compute_dtype {self.ssd_compute_dtype!r}")
        if self.ssm_chunk < 0:
            raise ValueError(f"Rules: ssm_chunk {self.ssm_chunk} < 0")

    # ----- axis sizes -----

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.mesh is None:
            return (*self.data_axes, self.model_axis)
        return tuple(self.mesh.mesh_dim_names)

    @property
    def axis_sizes(self) -> dict:
        """{axis name: mesh size}, the form the restore planner consumes
        (``ckpt/plan.py`` ``dim_slices_for_spec``)."""
        if self.mesh is None:
            return {a: 1 for a in self.axis_names}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or names)."""
        sizes = self.axis_sizes
        return math.prod(sizes[a] for a in _names(axes))

    @property
    def data_size(self) -> int:
        return self.size(self.data_axes)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return (*self.data_axes, self.model_axis)

    @property
    def total_size(self) -> int:
        return self.data_size * self.model_size

    def coords_of_rank(self, rank: int) -> dict:
        """Mesh coordinates of flat device ``rank`` (C order over the axis
        names): the per-axis indices a restore planner needs to slice this
        rank's shard of every checkpointed tensor."""
        coords = {}
        rem = int(rank)
        sizes = self.axis_sizes
        for a in reversed(self.axis_names):
            coords[a] = rem % sizes[a]
            rem //= sizes[a]
        return coords

    # ----- spec helpers -----

    def dp(self, n: int):
        """Data-axes spec for a dim of size n (None if not shardable).
        Serving layout: batch/d_model replicate (no FSDP dim)."""
        if self.serving_layout:
            return None
        return self.data_axes if n % max(self.data_size, 1) == 0 else None

    def tp(self, n: int):
        """Feature-dim spec. Serving layout: both axes when divisible."""
        if self.serving_layout and n % max(self.total_size, 1) == 0:
            return self.all_axes
        return self.model_axis if n % max(self.model_size, 1) == 0 else None

    @property
    def cache_axes(self) -> tuple[str, ...]:
        """Axes sharding the KV-cache sequence dim."""
        return self.all_axes if self.serving_layout else (self.model_axis,)

    @property
    def reduce_axes(self) -> tuple[str, ...]:
        """Axes a feature-sharded contraction reduces over."""
        return self.all_axes if self.serving_layout else (self.model_axis,)

    # ----- activation specs -----

    def act_btd(self, batch: int, seq: int = 0) -> tuple:
        """[B, S, D] activations. With ``seq_sharded_acts`` the sequence
        dim shards over the model axis (pass ``seq``; replicated when it
        does not divide, e.g. decode's S = 1)."""
        if self.seq_sharded_acts and seq and \
                seq % max(self.model_size, 1) == 0:
            return (self.dp(batch), self.model_axis, None)
        return (self.dp(batch), None, None)

    def act_logits(self, batch: int, vocab: int = 0) -> tuple:
        """[B, S, V] logits (vocab feature-sharded)."""
        v = self.tp(vocab) if vocab else self.model_axis
        return (self.dp(batch), None, v)

    def act_ff(self, batch: int) -> tuple:
        """[B, S, F] MLP hidden."""
        return (self.dp(batch), None, self.model_axis)

    def seq_attn(self, batch: int) -> tuple:
        """[B, S, H, Dh] q/k/v inside sequence-sharded attention."""
        return (self.dp(batch), self.model_axis, None, None)

    def kv_cache(self, batch: int) -> tuple:
        """[B, W, Hkv, Dh] cache: window/sequence dim over model."""
        return (self.dp(batch), self.model_axis, None, None)

    def ssm_state(self, batch: int) -> tuple:
        """[B, H, P, N] SSM state: heads over model."""
        return (self.dp(batch), self.model_axis, None, None)

    # ----- parameter specs -----

    def param_specs(self, cfg: ModelConfig) -> dict:
        """Spec tree congruent with ``Model.init(cfg)``'s parameters."""
        from repro_torch.models.model import map_schema, param_schema
        return map_schema(lambda leaf: leaf.spec, param_schema(cfg, self))

    def use_spec(self, spec: tuple) -> tuple:
        """A parameter's spec where it is used: its FSDP entries (the data
        axes) gathered, its feature entries kept."""
        return tuple(None if e == self.data_axes else e for e in spec)

    # ----- DTensor placements -----

    def placements(self, spec: tuple) -> list:
        """The DTensor placements of ``spec`` on the mesh: ``Shard(i)`` on
        each mesh dim that shards tensor dim i, ``Replicate()`` elsewhere.
        Axes that share a tensor dim must come in mesh order (the first
        the major one, as in a PartitionSpec)."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.axis_names
        out = [Replicate()] * len(names)
        for i, entry in enumerate(spec):
            dims = [names.index(a) for a in _names(entry)]
            if dims != sorted(dims):
                raise ValueError(f"Rules.placements: axes {entry} are not in "
                                 f"the mesh's order {names}")
            for m in dims:
                out[m] = Shard(i)
        return out

    def shard_index(self, axes, coords: dict | None = None) -> int:
        """The flat index, in ``axes``' order (the first the major one), of
        this rank's shard over ``axes``; ``coords`` defaults to the mesh's
        coordinate of this process."""
        if coords is None:
            coords = self.local_coords()
        idx = 0
        sizes = self.axis_sizes
        for a in _names(axes):
            idx = idx * sizes[a] + coords[a]
        return idx

    def local_slices(self, shape, spec, coords: dict | None = None) -> tuple:
        """This rank's (or ``coords``') slice of a tensor of ``shape`` laid
        out by ``spec``: one ``slice`` a dim. Raises where a sharded dim
        does not divide."""
        if coords is None:
            coords = self.local_coords()
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        out = []
        for n, entry in zip(shape, spec):
            k = self.size(entry)
            if n % k:
                raise ValueError(f"Rules.local_slices: dim {n} does not "
                                 f"divide over {entry} ({k})")
            i = self.shard_index(entry, coords)
            out.append(slice(i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    def from_local(self, local, spec, shape):
        """A DTensor of global ``shape`` laid out by ``spec`` whose shard on
        this rank is ``local`` (no communication)."""
        from torch.distributed.tensor import DTensor
        shape = tuple(shape)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(local, self.mesh, self.placements(spec),
                                  run_check=False, shape=shape,
                                  stride=stride)

    def empty_dtensor(self, shape, spec, dtype, device):
        """``from_local`` of an empty local shard on ``device``."""
        import torch
        local = tuple(s.stop - s.start for s in
                      self.local_slices(shape, spec))
        return self.from_local(torch.empty(local, dtype=dtype, device=device),
                               spec, shape)

    def local_coords(self) -> dict:
        """This process's coordinate on each mesh axis (0 on one device)."""
        if self.mesh is None:
            return {a: 0 for a in self.axis_names}
        return {a: int(self.mesh.get_local_rank(a)) for a in self.axis_names}


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def make_rules(mesh, *, moe_sharding: str = "tp", **kw) -> Rules:
    """Rules over ``mesh``: a ``pod`` axis goes in front of the data axes."""
    axes = tuple(mesh.mesh_dim_names)
    data_axes = ("pod", "data") if "pod" in axes else ("data",)
    return Rules(mesh=mesh, data_axes=data_axes, moe_sharding=moe_sharding,
                 **kw)


def single_device_rules(**kw) -> Rules:
    """One device over ("data", "model"), both of size 1, no mesh: the
    model runs on plain tensors."""
    return Rules(mesh=None, **kw)
