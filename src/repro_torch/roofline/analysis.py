"""Three-term roofline of one NVIDIA H100 SXM, from a step's count (the dry
run's, ``launch/dryrun.py``, or a count of the real step on the card).

Hardware constants (NVIDIA's data sheet, dense, at the 700 W power limit):
  bf16 tensor-core peak 989 TFLOP/s, fp32 outside the tensor cores 67
  TFLOP/s, HBM3 3.35 TB/s; NVLink 900 GB/s a card to the others of its
  host, all to all, 450 GB/s each way (not used on one card).

Terms (seconds per step, per card):
  compute    = FLOPs_bf16 / PEAK_FLOPS + FLOPs_fp32 / PEAK_FP32_FLOPS
  memory     = bytes / HBM_BW
  collective = collective bytes / LINK_BW

A port of the JAX package's ``roofline/analysis.py`` with the H100's
constants: the same report, fields and table. The compute term prices the
fp32 GEMMs (``cost["flops_fp32"]``, ``roofline/step_cost.py``'s split) at
the fp32 rate, since TF32 is off; a cost without that entry is priced as
the reference prices it, all at PEAK_FLOPS. MODEL_FLOPS uses the standard
6·N·D (train) / 2·N·D (forward-only) with N = active params for MoE; the
ratio MODEL_FLOPS / (FLOPs x chips) flags remat's recomputation (or, > 1,
an undercount).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

PEAK_FLOPS = 989e12        # bf16 FLOP/s, dense, tensor cores
PEAK_FP32_FLOPS = 67e12    # fp32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12           # bytes/s of device memory
LINK_BW = 450e9            # bytes/s each way over NVLink


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    step_kind: str                 # train | prefill | decode
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: dict
    model_flops_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_flops_ratio: float
    memory_per_device_bytes: Optional[float] = None
    notes: str = ""

    def to_json(self) -> dict:
        return asdict(self)


def model_flops(cfg, shape, *, step_kind: str) -> float:
    """6·N·D (train) or 2·N·D (fwd) with N = active params; adds the
    quadratic attention term which 6ND ignores."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if step_kind != "decode"
                                   else 1)
    mult = 6.0 if step_kind == "train" else 2.0
    base = mult * n_active * tokens

    # attention matmul FLOPs (QK^T + PV): 2 * 2 * S_kv * d_head * heads
    if cfg.num_heads:
        s_kv = shape.seq_len
        window = cfg.sliding_window or 0
        if window and window < s_kv:
            s_kv = window
        if cfg.arch_type == "hybrid":
            n_attn_layers = -(-cfg.num_layers // cfg.shared_attention_every)
        else:
            n_attn_layers = cfg.num_layers
        q_tokens = tokens
        causal_frac = 0.5 if step_kind != "decode" and not window else 1.0
        attn = (2 * 2 * q_tokens * s_kv * cfg.num_heads * cfg.head_dim
                * n_attn_layers * causal_frac)
        if step_kind == "train":
            attn *= 3  # fwd + 2x bwd
        base += attn
    return base


def analyze(*, arch: str, shape, mesh_name: str, chips: int, step_kind: str,
            cost: dict, collectives: dict, cfg,
            memory_per_device: Optional[float] = None,
            notes: str = "") -> RooflineReport:
    flops_dev = float(cost.get("flops", 0.0))
    fp32_dev = float(cost.get("flops_fp32", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(collectives.get("total", 0.0))

    compute_s = (flops_dev - fp32_dev) / PEAK_FLOPS + fp32_dev / PEAK_FP32_FLOPS
    memory_s = bytes_dev / HBM_BW
    coll_s = coll_dev / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)

    mf = model_flops(cfg, shape, step_kind=step_kind)
    ratio = mf / max(flops_dev * chips, 1.0)

    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        step_kind=step_kind, hlo_flops_per_device=flops_dev,
        hlo_bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev,
        collective_detail=collectives,
        model_flops_global=mf, compute_s=compute_s, memory_s=memory_s,
        collective_s=coll_s, bottleneck=bottleneck,
        useful_flops_ratio=ratio, memory_per_device_bytes=memory_per_device,
        notes=notes)


def format_table(reports: list[RooflineReport]) -> str:
    head = (f"{'arch':<20} {'shape':<12} {'mesh':<9} {'step':<7} "
            f"{'compute_s':>10} {'memory_s':>10} {'collect_s':>10} "
            f"{'bound':<10} {'useful':>7} {'GB/dev':>8}")
    lines = [head, "-" * len(head)]
    for r in reports:
        gb = (r.memory_per_device_bytes or 0) / 2**30
        lines.append(
            f"{r.arch:<20} {r.shape:<12} {r.mesh:<9} {r.step_kind:<7} "
            f"{r.compute_s:>10.4f} {r.memory_s:>10.4f} "
            f"{r.collective_s:>10.4f} {r.bottleneck:<10} "
            f"{r.useful_flops_ratio:>7.2f} {gb:>8.2f}")
    return "\n".join(lines)
