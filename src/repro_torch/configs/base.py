"""Base configuration dataclasses: a copy of the JAX package's
``configs/base.py`` (pure data, so both packages build identical configs).

``ModelConfig`` captures everything needed to build any of the assigned
architectures (dense / MoE / SSM / hybrid / VLM / audio backbones).
``ShapeConfig`` captures an assigned input shape (train / prefill / decode).

Configs are plain frozen dataclasses so they hash, print, and diff cleanly;
every architecture file in this package exports ``CONFIG`` (the exact assigned
full-size config) and ``tiny()`` (a reduced same-family variant used by smoke
tests: <=2 layers, d_model<=512, <=4 experts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    experts_per_token: int
    # Capacity factor used by the sort-based dropping dispatch.  Tokens beyond
    # ``capacity = ceil(tokens * experts_per_token / num_experts * cf)`` for an
    # expert are dropped (standard Switch/MaxText-style behaviour).
    capacity_factor: float = 1.25
    # Router jitter / load-balance aux-loss weight (Switch-style).
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state space duality) block configuration."""

    state_dim: int = 128        # N, the SSM state size per head
    head_dim: int = 64          # P, channels per SSD head
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4         # depthwise causal conv kernel size
    chunk_size: int = 256       # SSD chunk length for the chunked-scan algo
    ngroups: int = 1            # B/C groups (GVA-style sharing)


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only transformer / SSM / hybrid backbone configuration."""

    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    source: str                 # citation for the assignment table entry

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4       # GQA: kv heads (== num_heads -> MHA)
    d_ff: int = 1024            # per-expert d_ff when MoE
    vocab_size: int = 1024

    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False      # Qwen-style attention bias
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Sliding-window attention width; 0 = full causal attention.
    sliding_window: int = 0
    # M-RoPE (Qwen2-VL): 3-D multimodal rotary position ids.
    mrope: bool = False
    # Section sizes for M-RoPE (temporal, height, width) in head_dim/2 units.
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (Zamba2): Mamba2 backbone with ONE shared attention block applied
    # every ``shared_attention_every`` layers (weights reused each invocation).
    shared_attention_every: int = 0

    # Modality frontend stub: "none" | "audio" (EnCodec frames) | "vision"
    # (ViT patch embeddings).  The frontend itself is a stub per the brief;
    # input_specs() provides precomputed embeddings of the right shape.
    frontend: str = "none"

    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        assert self.arch_type in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"), self.arch_type
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                f"{self.name}: num_heads {self.num_heads} not divisible by kv {self.num_kv_heads}")

    # ----- derived quantities used by roofline / checkpoint sizing -----

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def param_count(self) -> int:
        """Exact parameter count of the backbone as we build it."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        total += d  # final norm
        per_layer = 0
        if self.arch_type in ("dense", "moe", "vlm", "audio"):
            per_layer += self._attn_params() + 2 * d  # two rmsnorm scales
            per_layer += self._mlp_params()
        elif self.arch_type == "ssm":
            per_layer += self._ssm_params() + d
        elif self.arch_type == "hybrid":
            per_layer += self._ssm_params() + d
        total += per_layer * self.num_layers
        if self.arch_type == "hybrid" and self.shared_attention_every:
            total += self._attn_params() + self.d_model  # one shared block
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            p += nq * hd + 2 * nkv * hd
        return p

    def _mlp_params(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.moe:
            e = self.moe.num_experts
            return e * (3 * d * f) + d * e  # experts + router
        return 3 * d * f  # SwiGLU gate/up/down

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        di = self.ssm.expand * d
        n = self.ssm.state_dim
        g = self.ssm.ngroups
        heads = di // self.ssm.head_dim
        # in_proj -> [z, x, B, C, dt] ; conv over (x,B,C); out_proj
        proj_in = d * (2 * di + 2 * g * n + heads)
        conv = self.ssm.conv_width * (di + 2 * g * n)
        other = heads * 2 + heads  # A_log, D, dt_bias
        proj_out = di * d
        return proj_in + conv + other + proj_out

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        e, k = self.moe.num_experts, self.moe.experts_per_token
        dense_experts = e * (3 * d * f) * self.num_layers
        active_experts = k * (3 * d * f) * self.num_layers
        return self.param_count() - dense_experts + active_experts

    def checkpoint_bytes(self, bytes_per_param: int = 4) -> int:
        return self.param_count() * bytes_per_param


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned input shapes (verbatim from the brief).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the smoke-test variant: same family, tiny dims."""
    small: dict = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.num_heads:
        # keep the GQA ratio if possible
        ratio = cfg.num_heads // max(cfg.num_kv_heads, 1)
        nh = 4
        small["num_heads"] = nh
        small["num_kv_heads"] = max(1, nh // min(ratio, nh))
        small["head_dim"] = small["d_model"] // nh
    if cfg.d_ff:
        small["d_ff"] = min(cfg.d_ff, 512)
    if cfg.moe:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
        )
    if cfg.ssm:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16), chunk_size=32,
            head_dim=min(cfg.ssm.head_dim, 32))
    if cfg.sliding_window:
        small["sliding_window"] = 64
    if cfg.shared_attention_every:
        small["shared_attention_every"] = 2
    if cfg.mrope:
        half = small["d_model"] // small.get("num_heads", 4) // 2
        hw = half * 3 // 8
        small["mrope_sections"] = (half - 2 * hw, hw, hw)
    small["name"] = cfg.name + "-tiny"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
