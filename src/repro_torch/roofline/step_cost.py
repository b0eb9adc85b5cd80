"""The cost of a step counted from what it runs: the counterpart of the JAX
package's ``roofline/jaxpr_cost.analytic_cost``.

The reference traces a step to a jaxpr and walks its equations. PyTorch
runs eagerly, so the count here watches the step run, under a
``TorchDispatchMode`` that sees every operator below autograd: the forward,
the backward (and remat's recomputation, which runs again) and the
optimizer, each kernel operator of ``kernels/ops.py`` as one operator. The
step runs on real tensors (the CPU, the card) or on the meta device (the
dry run), where nothing is computed and the count is the same.

Conventions, as the reference's where it has one:
  FLOPs: matmul-class operators only, by ``torch.utils.flop_counter``'s
    formulas (2 M N K for a product; the kernel operators' own formulas,
    from ``roofline/kernel_cost.py``), split by the dtype of the product's
    first floating operand: ``flops_bf16``, ``flops_fp32`` (an fp32 GEMM
    runs on the CUDA cores, TF32 being off). Elementwise work is not
    counted; the reference counts one FLOP per element of it.
  bytes: the operands plus the results of every operator that is not a
    view, each tensor by its own elements: a no-fusion upper bound. An
    in-place write into a slice of a large buffer (the ring cache)
    counts the whole buffer when the operator takes it whole
    (``index_put_``), but only the slice when it takes a view.
  memory: the bytes of the storages alive on the step's device, each
    rounded up to the card's 512-byte allocation unit: those of the
    arguments, and each one an operator makes, until it is freed (a
    weak reference's callback), and their peak. Storages a kernel wrapper
    allocates inside its operator are not seen (the flash backward's fp32
    scratch, at most 0.4 GB at the cells' shapes); the SSD backward's
    workspace is an argument of its operator and is, and so are the
    training loss's two workspaces (``kernels/unembed_ce.py``: every
    chunk buffer; only a few [T] vectors inside them, the labels in
    int32 and the loss's terms, are not).
  DTensors (a sharded step): the mode steps aside for every operator on
    DTensors (``NotImplemented``, as ``CommDebugMode`` does), so DTensor
    runs it and what it runs on the local shards comes back through the
    mode: FLOPs, bytes and storages are this rank's, and the functional
    collectives DTensor issues are counted by kind (``collectives``), by
    the reference's ring convention (``roofline/hlo.py``): an all-gather
    the bytes it receives (output - input), a reduce-scatter those it
    sends away (input - output), an all-reduce twice its input, an
    all-to-all its input.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels.ops  # noqa: F401  (registers the kernels' formulas)

ALLOC_UNIT = 512  # bytes: the CUDA caching allocator's rounding


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree, each DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# the functional collectives, by kind, and how their bytes count
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _collective_bytes(kind: str, ins: list, outs: list) -> int:
    i = sum(map(_nbytes, ins))
    o = sum(map(_nbytes, outs))
    if kind == "all-gather":
        return max(o - i, 0)
    if kind == "reduce-scatter":
        return max(i - o, 0)
    if kind == "all-reduce":
        return 2 * i
    return i


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_UNIT) * ALLOC_UNIT


class StepCount(TorchDispatchMode):
    """Within ``with``: FLOPs, bytes and calls by operator, and the live
    storages on the device of the first tensor in ``args`` (a tree), which
    are counted as alive from the start."""

    def __init__(self, args=()):
        super().__init__()
        self.flops: dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.by_op: dict[str, dict] = {}
        self.collective_bytes: dict[str, float] = defaultdict(float)
        tensors = _tensors(args)
        self.device = tensors[0].device.type if tensors else None
        self._live: dict[int, int] = {}
        self._finalizers: list = []
        # a backward on the card runs in autograd's device thread, whose
        # frees may come while this thread tracks
        self._lock = threading.Lock()
        self.now = self.peak = 0
        for t in tensors:
            self._track(t)
        self.argument_bytes = self.now

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            size = _rounded(st.nbytes())
            self._live[key] = size
            self.now += size
            self.peak = max(self.peak, self.now)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        with self._lock:
            self.now -= self._live.pop(key, 0)

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on the shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        name = str(func.overloadpacket)
        op = self.by_op.setdefault(name, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        op["calls"] += 1
        op["bytes"] += nbytes
        self.bytes += nbytes
        kind = _COLLECTIVES.get(func.overloadpacket.__name__)
        if kind is not None:
            self.collective_bytes[kind] += _collective_bytes(kind, ins, outs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            dtype = next((t.dtype for t in ins if t.is_floating_point()),
                         torch.float32)
            self.flops[str(dtype).removeprefix("torch.")] += flops
            op["flops"] += flops
        return out

    def cost(self) -> dict:
        """{"flops", "flops_bf16", "flops_fp32" (and any other dtype's),
        "bytes", "by_op": {operator: {"calls", "flops", "bytes"}}}."""
        split = {f"flops_{k}": v for k, v in sorted(self.flops.items())}
        split.setdefault("flops_bfloat16", 0.0)
        split.setdefault("flops_float32", 0.0)
        return {"flops": sum(self.flops.values()),
                "flops_bf16": split.pop("flops_bfloat16"),
                "flops_fp32": split.pop("flops_float32"), **split,
                "bytes": self.bytes,
                "by_op": dict(sorted(self.by_op.items()))}

    def collectives(self) -> dict:
        """Bytes by collective kind on this rank, and their ``total``."""
        out = dict(sorted(self.collective_bytes.items()))
        out["total"] = sum(out.values())
        return out

    def memory(self) -> dict:
        return {"argument_size_in_bytes": self.argument_bytes,
                "peak_memory_in_bytes": self.peak}


def analytic_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (real, or meta tensors) and count it:
    ``StepCount.cost()``."""
    with StepCount((args, kwargs)) as count:
        fn(*args, **kwargs)
    return count.cost()
