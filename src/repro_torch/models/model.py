"""The decoder-only LM in PyTorch, dense, MoE, SSM (Mamba2), hybrid
(Zamba2) and frontend (vlm, audio) families: the counterpart of the JAX
package's ``models/model.py``. The MoE family is the dense one with each
layer's MLP a mixture-of-experts block (``models/moe.py``), on one device.
The frontend families are the dense one fed, in ``prefill`` and
``train_loss``, with stand-in embeddings (``batch["embeddings"]``, from
``models/frontend.py``) in place of tokens, and for qwen2-vl with 3-D
M-RoPE positions (``batch["mrope_pos"]``); from tokens they run as the
dense family does.

Parameters keep the reference's names, shapes and ``x @ W`` orientation:
stacked ``[L, ...]`` leaves under ``params["layers"]`` (``wq`` is
``[L, d, nq * hd]``, not ``nn.Linear``'s ``[out, in]``), so a checkpoint
can name its entries the same way in both packages. The hybrid family
also has one unstacked attention block, ``params["shared_attn"]``, run
before every ``shared_attention_every``-th Mamba2 layer with the same
weights each time. The layer loop is a Python loop over the views
``layers[name][i]`` (``_schedule``).

The reference keeps fp32 masters and casts each to the compute dtype where
it is used. For serving, a parameter the reference only uses in the
compute dtype is cast once, when it is made or loaded: the same bits at
half the memory. For training, ``init(..., dtype=torch.float32)`` keeps
fp32 masters and every use casts, as the reference does. The SSM leaves
the reference uses in fp32 (``A_log``, ``ssm_D``, ``dt_bias``, the conv
weights and biases: ``Leaf.fp32``) stay fp32 and are cast where the
reference casts them.

Three entry points, matching the reference's:
  ``prefill``      fills the caches (a ring KV cache for each attention
                   call, the SSM and conv states for each Mamba2 layer),
                   returns last-token fp32 logits;
  ``decode_step``  one new token against those caches, updated in place;
  ``train_loss``   mean cross-entropy of full-sequence fp32 logits (on
                   one device made a vocabulary chunk at a time, never
                   whole), each layer recomputed in the backward pass
                   (``remat``) as under the reference's ``Rules.remat``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import namedtuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import (attention_op, ssd_op,
                                     unembed_cross_entropy)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding.rules import Rules, single_device_rules

# init is ("normal", std), ("ones",), ("zeros",), ("a_log",) or
# ("dt_bias",); fp32: kept in fp32 whatever the compute dtype; spec: the
# reference's PartitionSpec as a tuple (sharding/rules.py)
Leaf = namedtuple("Leaf", ["shape", "init", "fp32", "spec"],
                  defaults=(False, None))

# the most elements Model.init draws in fp32 at once (0.5 GB)
_INIT_PART = 1 << 27
# the families whose layers are attention + MLP (or MoE), as _dense_leaves
TRANSFORMER_ARCH_TYPES = ("dense", "moe", "vlm", "audio")
# the per-layer cache entries of a Mamba2 layer and of an attention call
SSM_CACHE = ("ssm", "conv_x", "conv_B", "conv_C")
KV_CACHE = ("k", "v", "slot_pos")


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current card for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises rather than carry on without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def _ssm_leaves(cfg: ModelConfig, r: Rules) -> dict:
    """The reference's ``_ssm_leaves``: one Mamba2 block per layer."""
    s = cfg.ssm
    d, n = cfg.d_model, cfg.num_layers
    di = s.expand * d
    h = di // s.head_dim
    gn = s.ngroups * s.state_dim
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * n))
    return {
        "norm": Leaf((n, d), ("ones",), False, (None, None)),
        "z_proj": Leaf((n, d, di), s_in, False, (None, r.dp(d), r.tp(di))),
        "x_proj": Leaf((n, d, di), s_in, False, (None, r.dp(d), r.tp(di))),
        "B_proj": Leaf((n, d, gn), s_in, False, (None, r.dp(d), None)),
        "C_proj": Leaf((n, d, gn), s_in, False, (None, r.dp(d), None)),
        "dt_proj": Leaf((n, d, h), s_in, False, (None, r.dp(d), r.tp(h))),
        "conv_x_w": Leaf((n, s.conv_width, di), ("normal", 0.2), True,
                         (None, None, r.tp(di))),
        "conv_x_b": Leaf((n, di), ("zeros",), True, (None, r.tp(di))),
        "conv_B_w": Leaf((n, s.conv_width, gn), ("normal", 0.2), True,
                         (None, None, None)),
        "conv_B_b": Leaf((n, gn), ("zeros",), True, (None, None)),
        "conv_C_w": Leaf((n, s.conv_width, gn), ("normal", 0.2), True,
                         (None, None, None)),
        "conv_C_b": Leaf((n, gn), ("zeros",), True, (None, None)),
        "A_log": Leaf((n, h), ("a_log",), True, (None, r.tp(h))),
        "ssm_D": Leaf((n, h), ("ones",), True, (None, r.tp(h))),
        "dt_bias": Leaf((n, h), ("dt_bias",), True, (None, r.tp(h))),
        "gate_norm": Leaf((n, di), ("ones",), False, (None, r.tp(di))),
        "out_proj": Leaf((n, di, d), s_out, False, (None, r.tp(di), r.dp(d))),
    }


def param_schema(cfg: ModelConfig, r: Rules | None = None) -> dict:
    """Shapes, initialisers and specs of the parameters, under the
    reference's names: Leaf entries, nested in dicts. The specs are the
    reference's ``param_schema``'s, derived from ``r`` as there (one
    device's, sizes 1, without it)."""
    r = r or single_device_rules()
    d, v = cfg.d_model, cfg.vocab_size
    schema = {"embed": Leaf((v, d), ("normal", 0.02), False,
                            (r.tp(v), r.dp(d))),
              "final_norm": Leaf((d,), ("ones",), False, (None,))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = Leaf((d, v), ("normal", 0.02), False,
                                 (r.dp(d), r.tp(v)))
    if cfg.arch_type in TRANSFORMER_ARCH_TYPES:
        schema["layers"] = _dense_leaves(cfg, r)
    else:
        schema["layers"] = _ssm_leaves(cfg, r)
    if cfg.arch_type == "hybrid":
        # one block, its output scale that of a one-layer model
        schema["shared_attn"] = _attn_leaves(
            dataclasses.replace(cfg, num_layers=1), r, stacked=False)
    return schema


def _attn_leaves(cfg: ModelConfig, r: Rules, *,
                 stacked: bool = True) -> dict:
    """The reference's ``_attn_leaves``: [L, ...] leaves, or one block's."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    pre = (cfg.num_layers,) if stacked else ()
    lp = (None,) if stacked else ()
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * cfg.num_layers))
    leaves = {
        "attn_norm": Leaf(pre + (d,), ("ones",), False, (*lp, None)),
        "wq": Leaf(pre + (d, nq * hd), s_in, False,
                   (*lp, r.dp(d), r.tp(nq * hd))),
        "wk": Leaf(pre + (d, nkv * hd), s_in, False,
                   (*lp, r.dp(d), r.tp(nkv * hd))),
        "wv": Leaf(pre + (d, nkv * hd), s_in, False,
                   (*lp, r.dp(d), r.tp(nkv * hd))),
        "wo": Leaf(pre + (nq * hd, d), s_out, False,
                   (*lp, r.tp(nq * hd), r.dp(d))),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            leaves[name] = Leaf(pre + (n * hd,), ("zeros",), False,
                                (*lp, r.tp(n * hd)))
    return leaves


def _dense_leaves(cfg: ModelConfig, r: Rules) -> dict:
    """The reference's stacked ``_attn_leaves`` and ``_mlp_leaves``: a
    SwiGLU MLP, or with ``cfg.moe`` the router [L, D, E] and E experts'
    SwiGLU weights [L, E, D, F] / [L, E, F, D] (under ``"ep"`` the expert
    dim over ``model`` when E divides it, else the hidden dim as ``"tp"``)."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * n))
    layers = _attn_leaves(cfg, r)
    layers["mlp_norm"] = Leaf((n, d), ("ones",), False, (None, None))
    if cfg.moe:
        e = cfg.moe.num_experts
        if r.moe_sharding == "ep" and e % r.model_size == 0:
            espec = (r.model_axis, r.dp(d), None)
            espec_dn = (r.model_axis, None, r.dp(d))
        else:
            espec = (None, r.dp(d), r.tp(f))
            espec_dn = (None, r.tp(f), r.dp(d))
        layers.update({
            "router": Leaf((n, d, e), s_in, False, (None, r.dp(d), None)),
            "w_gate": Leaf((n, e, d, f), s_in, False, (None, *espec)),
            "w_up": Leaf((n, e, d, f), s_in, False, (None, *espec)),
            "w_down": Leaf((n, e, f, d), s_out, False, (None, *espec_dn)),
        })
    else:
        layers.update({
            "w_gate": Leaf((n, d, f), s_in, False, (None, r.dp(d), r.tp(f))),
            "w_up": Leaf((n, d, f), s_in, False, (None, r.dp(d), r.tp(f))),
            "w_down": Leaf((n, f, d), s_out, False,
                           (None, r.tp(f), r.dp(d))),
        })
    return layers


def init_parts(shape: tuple, prefix: tuple = ()):
    """The parts ``Model.init`` fills a leaf of ``shape`` in, in order, as
    (index, part shape): runs of whole rows of its first dimension of at
    most ``_INIT_PART`` elements, or, where one row is larger, each row's
    own parts in turn (the index ints, then a slice)."""
    rows = _INIT_PART * shape[0] // math.prod(shape)
    if rows:
        for lo in range(0, shape[0], rows):
            hi = min(lo + rows, shape[0])
            yield prefix + (slice(lo, hi),), (hi - lo,) + tuple(shape[1:])
        return
    for i in range(shape[0]):
        yield from init_parts(shape[1:], prefix + (i,))


def map_schema(fn, schema: dict, *trees: dict) -> dict:
    """``fn(leaf, *entries)`` over the schema's leaves, where each entry is
    the same name's in each of ``trees``: a tree of the schema's nesting,
    in its order."""
    return {name: (map_schema(fn, leaf, *(t[name] for t in trees))
                   if isinstance(leaf, dict)
                   else fn(leaf, *(t[name] for t in trees)))
            for name, leaf in schema.items()}


def ssm_mix(s_cfg, r: Rules, x: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, dtr: torch.Tensor, w: dict, cache: dict | None,
            mode: str) -> torch.Tensor:
    """The middle of a Mamba2 block, on the heads ``x`` holds (all of them
    on one device, a rank's on a mesh): the causal convs of x, B and C,
    dt = softplus(dt_raw + dt_bias) and the SSD scan (the kernel) over a
    whole sequence, or the one-token conv and state steps with ``mode``
    "decode". ``w`` holds the block's fp32 ``conv_*``, ``dt_bias``,
    ``A_log`` and ``ssm_D``; ``cache`` (None in training) takes the new
    SSM and conv states in place. The scan takes the rules' SSD knobs as
    the reference's ``mamba_sublayer`` does: ``ssm_chunk or chunk_size``
    and ``ssd_compute_dtype``. Returns y [B, S, heads * head_dim]."""
    b, s = x.shape[:2]
    pd, g, n = s_cfg.head_dim, s_cfg.ngroups, s_cfg.state_dim
    nh = x.shape[-1] // pd
    A = -torch.exp(w["A_log"])
    if mode in ("train", "prefill"):
        x, cx = ssm_lib.causal_conv(x, w["conv_x_w"], w["conv_x_b"])
        Bm, cb = ssm_lib.causal_conv(Bm, w["conv_B_w"], w["conv_B_b"])
        Cm, cc = ssm_lib.causal_conv(Cm, w["conv_C_w"], w["conv_C_b"])
        dt = F.softplus(dtr.float() + w["dt_bias"])
        y, state = ssd_op(x.reshape(b, s, nh, pd), dt, A,
                          Bm.reshape(b, s, g, n), Cm.reshape(b, s, g, n),
                          w["ssm_D"], chunk=r.ssm_chunk or s_cfg.chunk_size,
                          compute_dtype=getattr(torch, r.ssd_compute_dtype))
    elif mode == "decode":
        x1, cx = ssm_lib.conv_decode_step(cache["conv_x"], x[:, 0],
                                          w["conv_x_w"], w["conv_x_b"])
        B1, cb = ssm_lib.conv_decode_step(cache["conv_B"], Bm[:, 0],
                                          w["conv_B_w"], w["conv_B_b"])
        C1, cc = ssm_lib.conv_decode_step(cache["conv_C"], Cm[:, 0],
                                          w["conv_C_w"], w["conv_C_b"])
        dt1 = F.softplus(dtr[:, 0].float() + w["dt_bias"])
        y, state = ssm_lib.ssd_decode_step(
            cache["ssm"], x1.reshape(b, nh, pd), dt1, A,
            B1.reshape(b, g, n), C1.reshape(b, g, n), w["ssm_D"])
    else:
        raise ValueError(f"mamba_sublayer: mode {mode!r}")
    if cache is not None:
        for name, new in (("ssm", state), ("conv_x", cx), ("conv_B", cb),
                          ("conv_C", cc)):
            cache[name].copy_(new)
    return y.reshape(b, -1, nh * pd)   # decode: [B, 1, ...]


class PlainOps:
    """The operations the layer code leaves to where it runs, on one
    device: plain tensor ops. ``models/sharded.py``'s ``ShardedPath`` has
    the same methods on DTensors, with the reference's collectives and
    ``shard_map`` islands. ``spec`` arguments are the reference's
    ``rules.constrain`` specs, nothing to do here."""

    def __init__(self, model: "Model"):
        self.model = model
        self.cfg = model.cfg

    def use(self, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A parameter where it is used, in ``dtype``."""
        return w.to(dtype)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def put(self, x: torch.Tensor, spec) -> torch.Tensor:
        return x

    def shard_input(self, t: torch.Tensor, spec) -> torch.Tensor:
        return t

    def view(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Entry i of a stacked leaf or cache: a view, written in place."""
        return t[i]

    def value(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        return L.embed(tokens.long(), table, self.model.compute_dtype)

    def ring(self, caches: dict, s: int, w: int):
        """Ring slot g holds position p0 + (g - p0) mod w, p0 = max(0, s -
        w): the last w positions; slots past the prompt stay empty (-1,
        zeros). The filled slots are the first min(s, w), known on the
        host: no data-dependent shape, no read back. Writes every call's
        slot positions; returns (slots, their positions) for the k/v."""
        p0 = max(0, s - w)
        slots = torch.arange(min(s, w), device=self.model.device)
        src = p0 + torch.remainder(slots - p0, w)
        caches["slot_pos"][:, slots] = src.to(torch.int32)
        return slots, src

    def seq_attention(self, q, k, v, positions, mrope_pos, cache, ring):
        """RoPE, then the flash kernel over the whole sequence; with
        ``cache`` (this call's views of the ring) the rotated k and v go
        into it. q, k, v [B, S, heads * head_dim]; returns [B, S, Hq, D]."""
        cfg, m = self.cfg, self.model
        b, s, _ = q.shape
        q = m._rope(q.reshape(b, s, cfg.num_heads, cfg.head_dim), positions,
                    mrope_pos)
        k = m._rope(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
                    positions, mrope_pos)
        v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        out = attention_op(q, k, v, causal=True, window=cfg.sliding_window)
        if cache is not None:
            slots, src = ring
            cache["k"][:, slots] = k[:, src]
            cache["v"][:, slots] = v[:, src]
        return out

    def decode_attention(self, q, k, v, cache, pos, positions, mrope_pos):
        cfg = self.cfg
        b = q.shape[0]
        return self.model._decode_attend(
            q.reshape(b, 1, cfg.num_heads, cfg.head_dim),
            k.reshape(b, 1, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, 1, cfg.num_kv_heads, cfg.head_dim), cache, pos,
            positions, mrope_pos)

    def moe(self, p: dict, m: torch.Tensor):
        return moe_lib.moe_block(m, p["router"], p["w_gate"], p["w_up"],
                                 p["w_down"], moe=self.cfg.moe)

    def ssm(self, p, x, Bm, Cm, dtr, cache, mode):
        return ssm_mix(self.cfg.ssm, self.model.rules, x, Bm, Cm, dtr, p,
                       cache, mode)

    def unembed_cross_entropy(self, h: torch.Tensor, table: torch.Tensor,
                              labels) -> torch.Tensor:
        """The mean over positions of logsumexp(h @ table) - the label's
        logit, the logits made a vocabulary chunk at a time, never whole:
        ``kernels/ops.py``'s operator."""
        return unembed_cross_entropy(h, table, labels)


class Model:
    def __init__(self, cfg: ModelConfig, rules: Rules | None = None, *,
                 device: torch.device | str | None = None,
                 remat: bool | None = None):
        """``rules``: None (or ``single_device_rules()``) runs on one
        device on plain tensors; rules over a ``DeviceMesh``
        (``make_rules(mesh)``) run the sharded path, every parameter, cache
        and activation a DTensor with the reference's placements, at any
        mesh size, 1 included. The layer code is the same on both: what
        differs is ``self.ops``, ``PlainOps`` or ``models/sharded.py``'s
        ``ShardedPath``. ``device`` defaults to the card, or on a mesh to
        this rank's device of the mesh's type. ``remat``: recompute each
        layer in ``train_loss``'s backward pass instead of keeping its
        activations (the rules' ``remat``, on by default); the gradients
        are the same."""
        self.cfg = cfg
        self.rules = rules or single_device_rules()
        self.mesh = self.rules.mesh
        if device is None:
            device = "cuda" if self.mesh is None else _mesh_device(self.mesh)
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.remat = self.rules.remat if remat is None else remat
        if self.mesh is None:
            self.ops = PlainOps(self)
        else:
            from repro_torch.models.sharded import ShardedPath
            self.ops = ShardedPath(self)

    # ----- params -----

    def init(self, generator: torch.Generator, *,
             dtype: torch.dtype | None = None) -> dict:
        """Random parameters in ``dtype`` (default: the compute dtype, for
        serving; ``torch.float32`` for training's masters), ``Leaf.fp32``
        ones in fp32, drawn on the model's device from ``generator`` (which
        must live there too): the reference's distributions, not its
        numbers. Each leaf is made in its own dtype and filled in fp32 one
        part of its first dimension at a time (``_INIT_PART`` elements; a
        row larger than that, such as one layer of a stacked [L, ...] leaf,
        is filled in parts of its own first dimension in turn), so the
        peak is the tree and one part in fp32 (0.54 GB), not the tree and
        the whole leaf in fp32 (35.4 GB for moonshot-v1-16b-a3b's [48, 64,
        2048, 1408] ``w_gate``; 0.97 GB for one layer of qwen2-vl-72b's
        [L, 8192, 29568] one). On a mesh each leaf is drawn in the same
        parts on the generator's device (the CPU's, or the card's) and the
        rank keeps the intersection of each part with its slice, so every
        rank and every mesh shape holds slices of the weights one device
        draws from the same seed there."""
        dtype = dtype or self.compute_dtype

        dev = generator.device

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=dev)

        def draw(init: tuple, shape) -> torch.Tensor:
            kind = init[0]
            if kind == "ones":
                return torch.ones(shape, device=dev)
            if kind == "zeros":
                return torch.zeros(shape, device=dev)
            if kind == "a_log":  # A uniform in [1, 16] (Mamba2 default)
                return torch.log(uniform(shape, 1.0, 16.0))
            if kind == "dt_bias":
                # dt log-uniform in [1e-3, 1e-1], stored as inverse softplus
                dt = torch.exp(uniform(shape, math.log(1e-3), math.log(1e-1)))
                return dt + torch.log(-torch.expm1(-dt))
            return torch.randn(shape, generator=generator,
                               device=dev).mul_(init[1])

        def make(leaf: Leaf) -> torch.Tensor:
            out = torch.empty(leaf.shape, device=self.device,
                              dtype=torch.float32 if leaf.fp32 else dtype)
            for index, shape in init_parts(leaf.shape):
                out[index].copy_(draw(leaf.init, shape))
            return out

        if self.mesh is not None:
            return self.ops.init(dtype, draw)
        return map_schema(make, param_schema(self.cfg))

    def param_schema(self) -> dict:
        """``param_schema`` under this model's rules."""
        return param_schema(self.cfg, self.rules)

    def param_specs(self) -> dict:
        """The parameters' specs (``Rules.param_specs``)."""
        return self.rules.param_specs(self.cfg)

    def init_like(self, *, dtype: torch.dtype | None = None) -> dict:
        """``init``'s tree as meta tensors (names, shapes and dtypes, no
        memory): what a checkpoint restore is asked to fill. On a mesh,
        DTensors of meta local shards with the parameters' placements."""
        dtype = dtype or self.compute_dtype

        def make(leaf: Leaf) -> torch.Tensor:
            dt = torch.float32 if leaf.fp32 else dtype
            if self.mesh is not None:
                return self.rules.empty_dtensor(leaf.shape, leaf.spec, dt,
                                                "meta")
            return torch.empty(leaf.shape, device="meta", dtype=dt)

        return map_schema(make, self.param_schema())

    def serving_params(self, params: dict) -> dict:
        """``params`` (fp32 masters, or a serving tree) as ``init`` makes
        them for serving, on the model's device: every leaf in the compute
        dtype, ``Leaf.fp32`` ones in fp32. A master is rounded once, as
        the reference rounds it at each use."""
        def cast(leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
            dt = torch.float32 if leaf.fp32 else self.compute_dtype
            return t.to(dt) if self.mesh is not None else \
                t.to(self.device, dt)

        return map_schema(cast, param_schema(self.cfg), params)

    def count_params(self) -> int:
        sizes = []
        map_schema(lambda leaf: sizes.append(math.prod(leaf.shape)),
                   param_schema(self.cfg))
        return sum(sizes)

    # ----- layers -----

    def _proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w, the parameter cast to x's dtype where it is used."""
        return self.ops.mm(x, self.ops.use(w, x.dtype))

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(x, self.ops.use(w, x.dtype), self.cfg.norm_eps)

    def _act(self, b: int, s: int = 0):
        """``act_btd`` of a [B, S, D] residual: sequence-sharded (with
        ``seq_sharded_acts``) in the attention families only, as the
        reference's ``_act_seq`` (the SSM scan needs its whole sequence)."""
        seq = s if self.cfg.arch_type in TRANSFORMER_ARCH_TYPES else 0
        return self.rules.act_btd(b, seq)

    def _qkv(self, p: dict, a: torch.Tensor):
        """q, k, v [B, S, heads * head_dim], before RoPE."""
        dt = a.dtype
        q, k, v = (self._proj(a, p[n]) for n in ("wq", "wk", "wv"))
        if self.cfg.qkv_bias:
            q = q + self.ops.use(p["bq"], dt)
            k = k + self.ops.use(p["bk"], dt)
            v = v + self.ops.use(p["bv"], dt)
        return q, k, v

    def _rope(self, x: torch.Tensor, positions: torch.Tensor,
              mrope_pos: torch.Tensor | None) -> torch.Tensor:
        """M-RoPE over ``mrope_pos`` [B, S, 3] when the config has it and
        it is given, else RoPE over ``positions``: the reference's
        ``_rope``."""
        cfg = self.cfg
        if cfg.mrope and mrope_pos is not None:
            return L.apply_mrope(x, mrope_pos, cfg.rope_theta,
                                 cfg.mrope_sections)
        return L.apply_rope(x, positions, cfg.rope_theta)

    def _attention(self, p: dict, h: torch.Tensor, positions: torch.Tensor,
                   mrope_pos: torch.Tensor | None = None,
                   cache: dict | None = None, ring=None) -> torch.Tensor:
        """The attention sublayer over a whole sequence (prefill, train):
        returns h + attention. With ``cache`` (this call's views of the
        ring) the rotated k/v go into it at ``ring`` (``ops.ring``'s). The
        causal mask is the kernel's, over the 1-D ``positions``, whatever
        ``mrope_pos`` rotates by, as in the reference."""
        b, s, _ = h.shape
        q, k, v = self._qkv(p, self._norm(h, p["attn_norm"]))
        out = self.ops.seq_attention(q, k, v, positions, mrope_pos, cache,
                                     ring)
        y = self._proj(out.reshape(b, s, -1), p["wo"])
        return h + self.ops.put(y, self._act(b, s))

    def _decode_attend(self, q, k, v, cache: dict, pos: int,
                       positions: torch.Tensor, mrope_pos, *,
                       shard: int = 0, shards: int = 1, reduce=None):
        """One token (q, k, v [B, 1, H, D]) against the ring's slots on
        this device: all of them, or shard ``shard`` of ``shards`` along
        the slots, whose partial softmax ``reduce`` combines
        (``attention.distributed_decode_attention``). The token's k/v go
        to the slot ``pos`` mod the ring's length, on the shard that holds
        it."""
        q = self._rope(q, positions, mrope_pos)
        k = self._rope(k, positions, mrope_pos)
        w_loc = cache["k"].shape[1]
        slot = pos % (w_loc * shards) - shard * w_loc
        if 0 <= slot < w_loc:
            cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
            cache["slot_pos"][slot] = pos
        return attn.distributed_decode_attention(
            q, cache["k"], cache["v"], cache["slot_pos"], pos,
            window=self.cfg.sliding_window, reduce=reduce)

    def _train_layer(self, kind: str, p: dict, h: torch.Tensor,
                     positions: torch.Tensor,
                     mrope_pos: torch.Tensor | None = None):
        """One entry of ``_schedule`` over a whole sequence, no caches.
        Returns (h, the MoE block's aux, or None without one)."""
        if kind == "mamba":
            return self.mamba_sublayer(p, h, None, mode="train"), None
        h = self._attention(p, h, positions, mrope_pos)
        return self._mlp(p, h) if "mlp_norm" in p else (h, None)

    def _mlp(self, p: dict, h: torch.Tensor):
        """The MLP sublayer, SwiGLU or, with ``cfg.moe``, the MoE block
        over every token of the call. Returns (h, aux or None)."""
        b, s = h.shape[:2]
        m = self._norm(h, p["mlp_norm"])
        aux = None
        if self.cfg.moe:
            y, aux = self.ops.moe(p, m)
        else:
            g = F.silu(self._proj(m, p["w_gate"]))
            y = self._proj(g * self._proj(m, p["w_up"]), p["w_down"])
        return h + self.ops.put(y, self._act(b, s)), aux

    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """The first layer's input: ``batch["embeddings"]`` [B, S, D] (a
        frontend's output, fp32) cast to the compute dtype before any
        layer, as the reference casts it, or else the embedding rows of
        ``batch["tokens"]`` [B, S]."""
        if "embeddings" in batch:
            e = batch["embeddings"]
            h = self.ops.shard_input(e, self.rules.act_btd(e.shape[0]))
            h = h.to(self.compute_dtype)
        else:
            h = self.ops.embed(params["embed"], batch["tokens"])
        return self.ops.put(h, self._act(h.shape[0], h.shape[1]))

    def _logits(self, params: dict, h: torch.Tensor,
                unembed: torch.Tensor | None) -> torch.Tensor:
        """Serving's fp32 logits [B, S, V] (vocab-sharded on a mesh,
        ``act_logits``) of bf16 operands, as ``layers.unembed``; training
        takes ``unembed_cross_entropy`` instead."""
        h = self._norm(h, params["final_norm"])
        if unembed is None:
            unembed = self.unembed_table(params)
        logits = self.ops.mm(h.float(), unembed.float())
        return self.ops.put(logits, self.rules.act_logits(
            h.shape[0], self.cfg.vocab_size))

    def _unembed_in_compute_dtype(self, params: dict) -> torch.Tensor:
        """The unembedding table [d, V] in the compute dtype: the fp32
        master rounded to it, as the reference's unembed casts the table to
        the activations' dtype (tied: a transposed view of the embedding's
        cast)."""
        table = (params["embed"].t() if self.cfg.tie_embeddings
                 else params["lm_head"])
        return self.ops.use(table, self.compute_dtype)

    def unembed_table(self, params: dict) -> torch.Tensor:
        """The unembedding table [d, V] in fp32, made from ``params`` now.
        The entry points take it as ``unembed=`` so that a caller who
        unembeds often (the serving engine) upcasts the table once per set
        of weights, not on every call (151936 x 2048 at full width)."""
        return self._unembed_in_compute_dtype(params).float()

    def mamba_sublayer(self, p: dict, h: torch.Tensor, cache: dict | None,
                       *, mode: str) -> torch.Tensor:
        """One Mamba2 block: the reference's ``mamba_sublayer``. ``mode`` is
        "train" (no caches: ``cache`` is None, the final state is dropped
        and nothing is written), "prefill" (from zero states) or "decode"
        (one token); the last two write the new states into ``cache``, this
        layer's views of the SSM caches, in place. Each projection is cast
        to h's dtype where it is used, as the reference casts it. Returns h
        with the block's output added."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mamba_sublayer: mode {mode!r}")
        a = self._norm(h, p["norm"])
        z, x, Bm, Cm, dtr = (self._proj(a, p[n]) for n in (
            "z_proj", "x_proj", "B_proj", "C_proj", "dt_proj"))
        y = self.ops.ssm(p, x, Bm, Cm, dtr, cache, mode)
        gated = self._norm(y * F.silu(z), p["gate_norm"])
        out = self._proj(gated, p["out_proj"])
        return h + self.ops.put(out, self.rules.act_btd(h.shape[0]))

    def _schedule(self, params: dict) -> list[tuple[str, dict, int]]:
        """The layer stack in order, as (kind, parameters, cache index):
        "attn" is an attention sublayer (with its MLP or MoE block after
        it when the parameters have one, the dense and MoE families'),
        "mamba" a Mamba2 layer.
        The hybrid family runs ``params["shared_attn"]`` before every
        ``shared_attention_every``-th Mamba2 layer, as the reference's
        ``_apply_hybrid``; call j has cache index j."""
        cfg = self.cfg
        layers = self._layer_params(params)
        if cfg.arch_type in TRANSFORMER_ARCH_TYPES:
            return [("attn", p, i) for i, p in enumerate(layers)]
        every = cfg.shared_attention_every if cfg.arch_type == "hybrid" else 0
        out = []
        for i, p in enumerate(layers):
            if every and i % every == 0:
                out.append(("attn", params["shared_attn"], i // every))
            out.append(("mamba", p, i))
        return out

    def _views(self, caches: dict, names: tuple[str, ...], i: int) -> dict:
        """Entry i of the stacked caches ``names``: views, written in
        place."""
        return {name: self.ops.view(caches[name], i) for name in names}

    # ----- entry points -----

    def prefill(self, params: dict, batch: dict, *, cache_len: int,
                unembed: torch.Tensor | None = None):
        """Fill caches for ``batch``: ``tokens`` [B, S], or ``embeddings``
        [B, S, D] with, for M-RoPE, ``mrope_pos`` [B, S, 3]; ``unembed`` is
        ``unembed_table(params)``, made here if not given. The SSM family
        builds no ring and ignores ``cache_len``, as the reference does.
        Returns (last_logits [B, V] fp32, caches)."""
        h = self._embed_inputs(params, batch)
        b, s = h.shape[:2]
        mrope_pos = batch.get("mrope_pos")
        positions = torch.arange(s, device=self.device)
        caches = self.init_cache(b, cache_len)
        ring = (self.ops.ring(caches, s, self.cache_window(cache_len))
                if "k" in caches else None)
        for kind, p, i in self._schedule(params):
            if kind == "mamba":
                h = self.mamba_sublayer(p, h, self._views(caches, SSM_CACHE,
                                                          i), mode="prefill")
                continue
            h = self._attention(p, h, positions, mrope_pos,
                                self._views(caches, KV_CACHE, i), ring)
            if "mlp_norm" in p:
                h = self._mlp(p, h)[0]
        return self._logits(params, h[:, -1:], unembed)[:, 0], caches

    def decode_step(self, params: dict, tokens: torch.Tensor, caches: dict,
                    pos: int, *, unembed: torch.Tensor | None = None):
        """One token: tokens [B, 1]; pos, the absolute position; ``unembed``
        as in ``prefill``. With M-RoPE the token takes ``pos`` on all three
        streams, as the reference's ``decode_step`` does (after a vision
        prefill, Qwen2-VL itself would go on from the largest position + 1).
        Writes the token's k/v (or SSM and conv states) into ``caches`` in
        place (the reference donates the cache buffer) and returns
        (logits [B, V] fp32, caches)."""
        b = tokens.shape[0]
        h = self.ops.put(self.ops.embed(params["embed"], tokens),
                         self._act(b))
        positions = torch.arange(pos, pos + 1, device=self.device)
        mrope_pos = (torch.full((b, 1, 3), pos, dtype=torch.int32,
                                device=self.device) if self.cfg.mrope
                     else None)
        for kind, p, i in self._schedule(params):
            if kind == "mamba":
                h = self.mamba_sublayer(p, h, self._views(caches, SSM_CACHE,
                                                          i), mode="decode")
                continue
            q, k, v = self._qkv(p, self._norm(h, p["attn_norm"]))
            out = self.ops.decode_attention(q, k, v,
                                            self._views(caches, KV_CACHE, i),
                                            pos, positions, mrope_pos)
            y = self._proj(out.reshape(b, 1, -1), p["wo"])
            h = h + self.ops.put(y, self._act(b))
            if "mlp_norm" in p:
                h = self._mlp(p, h)[0]
        return self._logits(params, h, unembed)[:, 0], caches

    # ----- training -----

    def _layer_params(self, params: dict) -> list[dict]:
        """Each layer's parameters: ``params["layers"]`` as stacked [L, ...]
        leaves, sliced (on a mesh, DTensor views of the local shards), or
        already a list of per-layer dicts (the training step's leaf views,
        ``repro_torch.train.step``)."""
        layers = params["layers"]
        if isinstance(layers, (list, tuple)):
            return list(layers)
        return [{name: self.ops.view(t, i) for name, t in layers.items()}
                for i in range(self.cfg.num_layers)]

    def apply_layers(self, params: dict, h: torch.Tensor, *, mode: str,
                     positions: torch.Tensor,
                     mrope_pos: torch.Tensor | None = None):
        """The layer stack over a whole sequence without caches, as the
        reference's ``apply_layers(mode="train")``, with each entry of
        ``_schedule`` (a layer; for the hybrid family each shared-attention
        call and each Mamba2 layer apart, as the reference's
        ``_apply_hybrid``) checkpointed when ``remat``. Returns (h,
        aux_mean): the MoE blocks' aux summed over the layers and divided
        by their number, as the reference's scan does; 0 for the families
        without MoE. ``mrope_pos`` is an argument of each checkpointed call,
        so remat recomputes with the same positions. ``prefill`` and
        ``decode_step`` run their own loops, which write the caches."""
        if mode != "train":
            raise ValueError(f"apply_layers: mode {mode!r}; only 'train' runs "
                             "here (prefill and decode_step have their own "
                             "loops)")
        aux = None
        for kind, p, _ in self._schedule(params):
            if self.remat:
                h, aux_i = checkpoint(self._train_layer, kind, p, h,
                                      positions, mrope_pos,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                h, aux_i = self._train_layer(kind, p, h, positions,
                                             mrope_pos)
            if aux_i is not None:
                aux = aux_i if aux is None else aux + aux_i
        aux = (torch.zeros((), dtype=torch.float32, device=self.device)
               if aux is None else self.ops.value(aux))
        return h, aux / self.cfg.num_layers

    def train_loss(self, params: dict, batch: dict):
        """batch: tokens [B, S] or embeddings [B, S, D] (fp32; the
        ``embed`` leaf then takes no gradient), optional mrope_pos
        [B, S, 3], and labels [B, S]. Returns (loss, {"ce", "aux"}):
        ce, the mean over positions of logsumexp(logits) - logits[label]
        on fp32 logits of bf16 operands (``ops.unembed_cross_entropy``: on
        one device a vocabulary chunk at a time), plus, with ``cfg.moe``,
        ``router_aux_weight`` times the layers' mean load-balance aux, as
        the reference's ``train_loss``. The masters are cast to the
        compute dtype where they are used, inside each (checkpointed)
        layer, so remat keeps no copies of them. On a mesh the results
        are plain 0-d tensors, the same on every rank."""
        h = self._embed_inputs(params, batch)
        positions = torch.arange(h.shape[1], device=self.device)
        h, aux = self.apply_layers(params, h, mode="train",
                                   positions=positions,
                                   mrope_pos=batch.get("mrope_pos"))
        ce = self.ops.unembed_cross_entropy(
            self._norm(h, params["final_norm"]),
            self._unembed_in_compute_dtype(params), batch["labels"])
        loss = ce
        if self.cfg.moe:
            loss = ce + self.cfg.moe.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # ----- caches -----

    def cache_window(self, cache_len: int) -> int:
        """Physical cache length: the sliding window bounds it if set."""
        sw = self.cfg.sliding_window
        return sw if sw and sw < cache_len else cache_len

    def cache_shapes(self, batch: int, cache_len: int) -> dict:
        """One flat dict: the SSM and conv states stacked over the layers
        (SSM and hybrid families), and the ring's k, v and slot positions
        stacked over the attention calls (a layer each in the dense and MoE
        families, the ceil(L / every) shared-attention calls in the
        hybrid). The
        hybrid's dict holds the reference's tuple ``(mamba_caches,
        attn_caches)``: its first dict's entries, then its second's."""
        cfg = self.cfg
        shapes = {}
        if cfg.arch_type in ("ssm", "hybrid"):
            s = cfg.ssm
            di = s.expand * cfg.d_model
            gn = s.ngroups * s.state_dim
            conv = (cfg.num_layers, batch, s.conv_width - 1)
            shapes.update(ssm=(cfg.num_layers, batch, di // s.head_dim,
                               s.head_dim, s.state_dim),
                          conv_x=conv + (di,), conv_B=conv + (gn,),
                          conv_C=conv + (gn,))
        if cfg.arch_type != "ssm":
            calls = (cfg.num_layers if cfg.arch_type != "hybrid"
                     else -(-cfg.num_layers // cfg.shared_attention_every))
            w = self.cache_window(cache_len)
            kv = (calls, batch, w, cfg.num_kv_heads, cfg.head_dim)
            shapes.update(k=kv, v=kv, slot_pos=(calls, w))
        return shapes

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zero caches (slot_pos -1); the SSM state is fp32, every other
        state or k/v leaf is in the compute dtype. On a mesh, DTensors with
        the reference's ``cache_specs``."""
        if self.mesh is not None:
            return self.ops.init_cache(batch, cache_len)

        def make(name, shape):
            if name == "slot_pos":
                return torch.full(shape, -1, dtype=torch.int32,
                                  device=self.device)
            return torch.zeros(shape, device=self.device,
                               dtype=torch.float32 if name == "ssm"
                               else self.compute_dtype)

        return {name: make(name, shape) for name, shape in
                self.cache_shapes(batch, cache_len).items()}

