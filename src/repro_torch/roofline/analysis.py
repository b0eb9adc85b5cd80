"""Roofline constants of one NVIDIA H100 SXM and the model-FLOPs count.

Hardware constants (NVIDIA's data sheet, dense, at the 700 W power limit):
  bf16 tensor-core peak 989 TFLOP/s, fp32 outside the tensor cores 67
  TFLOP/s, HBM3 3.35 TB/s; NVLink 900 GB/s a card to the others of its
  host, all to all, 450 GB/s each way (not used on one card).

Terms (seconds per step, per card):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective bytes / LINK_BW

A port of the JAX package's ``roofline/analysis.py`` with the H100's
constants. MODEL_FLOPS uses the standard 6·N·D (train) / 2·N·D
(forward-only) with N = active params for MoE. The step-level ``analyze``
and ``format_table`` wait for the rest of ROADMAP A.9.
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
