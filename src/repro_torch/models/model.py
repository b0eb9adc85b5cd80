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
  ``train_loss``   mean cross-entropy of full-sequence fp32 logits, each
                   layer recomputed in the backward pass (``remat``) as
                   under the reference's ``Rules.remat``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import namedtuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import attention_op, ssd_op
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

# init is ("normal", std), ("ones",), ("zeros",), ("a_log",) or
# ("dt_bias",); fp32: kept in fp32 whatever the compute dtype
Leaf = namedtuple("Leaf", ["shape", "init", "fp32"], defaults=(False,))

# the most elements Model.init draws in fp32 at once (0.5 GB)
_INIT_PART = 1 << 27
# the families whose layers are attention + MLP (or MoE), as _dense_leaves
TRANSFORMER_ARCH_TYPES = ("dense", "moe", "vlm", "audio")
# the per-layer cache entries of a Mamba2 layer and of an attention call
SSM_CACHE = ("ssm", "conv_x", "conv_B", "conv_C")
KV_CACHE = ("k", "v", "slot_pos")


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises rather than carry on without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def _ssm_leaves(cfg: ModelConfig) -> dict:
    """The reference's ``_ssm_leaves``: one Mamba2 block per layer."""
    s = cfg.ssm
    d, n = cfg.d_model, cfg.num_layers
    di = s.expand * d
    h = di // s.head_dim
    gn = s.ngroups * s.state_dim
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * n))
    return {
        "norm": Leaf((n, d), ("ones",)),
        "z_proj": Leaf((n, d, di), s_in),
        "x_proj": Leaf((n, d, di), s_in),
        "B_proj": Leaf((n, d, gn), s_in),
        "C_proj": Leaf((n, d, gn), s_in),
        "dt_proj": Leaf((n, d, h), s_in),
        "conv_x_w": Leaf((n, s.conv_width, di), ("normal", 0.2), True),
        "conv_x_b": Leaf((n, di), ("zeros",), True),
        "conv_B_w": Leaf((n, s.conv_width, gn), ("normal", 0.2), True),
        "conv_B_b": Leaf((n, gn), ("zeros",), True),
        "conv_C_w": Leaf((n, s.conv_width, gn), ("normal", 0.2), True),
        "conv_C_b": Leaf((n, gn), ("zeros",), True),
        "A_log": Leaf((n, h), ("a_log",), True),
        "ssm_D": Leaf((n, h), ("ones",), True),
        "dt_bias": Leaf((n, h), ("dt_bias",), True),
        "gate_norm": Leaf((n, di), ("ones",)),
        "out_proj": Leaf((n, di, d), s_out),
    }


def param_schema(cfg: ModelConfig) -> dict:
    """Shapes and initialisers of the parameters, under the reference's
    names: Leaf entries, nested in dicts."""
    schema = {"embed": Leaf((cfg.vocab_size, cfg.d_model), ("normal", 0.02)),
              "final_norm": Leaf((cfg.d_model,), ("ones",))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size),
                                 ("normal", 0.02))
    if cfg.arch_type in TRANSFORMER_ARCH_TYPES:
        schema["layers"] = _dense_leaves(cfg)
    else:
        schema["layers"] = _ssm_leaves(cfg)
    if cfg.arch_type == "hybrid":
        # one block, its output scale that of a one-layer model
        schema["shared_attn"] = _attn_leaves(
            dataclasses.replace(cfg, num_layers=1), stacked=False)
    return schema


def _attn_leaves(cfg: ModelConfig, *, stacked: bool = True) -> dict:
    """The reference's ``_attn_leaves``: [L, ...] leaves, or one block's."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    pre = (cfg.num_layers,) if stacked else ()
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * cfg.num_layers))
    leaves = {
        "attn_norm": Leaf(pre + (d,), ("ones",)),
        "wq": Leaf(pre + (d, nq * hd), s_in),
        "wk": Leaf(pre + (d, nkv * hd), s_in),
        "wv": Leaf(pre + (d, nkv * hd), s_in),
        "wo": Leaf(pre + (nq * hd, d), s_out),
    }
    if cfg.qkv_bias:
        leaves["bq"] = Leaf(pre + (nq * hd,), ("zeros",))
        leaves["bk"] = Leaf(pre + (nkv * hd,), ("zeros",))
        leaves["bv"] = Leaf(pre + (nkv * hd,), ("zeros",))
    return leaves


def _dense_leaves(cfg: ModelConfig) -> dict:
    """The reference's stacked ``_attn_leaves`` and ``_mlp_leaves``: a
    SwiGLU MLP, or with ``cfg.moe`` the router [L, D, E] and E experts'
    SwiGLU weights [L, E, D, F] / [L, E, F, D]."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * n))
    layers = _attn_leaves(cfg)
    layers["mlp_norm"] = Leaf((n, d), ("ones",))
    if cfg.moe:
        e = cfg.moe.num_experts
        layers.update({
            "router": Leaf((n, d, e), s_in),
            "w_gate": Leaf((n, e, d, f), s_in),
            "w_up": Leaf((n, e, d, f), s_in),
            "w_down": Leaf((n, e, f, d), s_out),
        })
    else:
        layers.update({
            "w_gate": Leaf((n, d, f), s_in),
            "w_up": Leaf((n, d, f), s_in),
            "w_down": Leaf((n, f, d), s_out),
        })
    return layers


def map_schema(fn, schema: dict, *trees: dict) -> dict:
    """``fn(leaf, *entries)`` over the schema's leaves, where each entry is
    the same name's in each of ``trees``: a tree of the schema's nesting,
    in its order."""
    return {name: (map_schema(fn, leaf, *(t[name] for t in trees))
                   if isinstance(leaf, dict)
                   else fn(leaf, *(t[name] for t in trees)))
            for name, leaf in schema.items()}


class Model:
    def __init__(self, cfg: ModelConfig, *, device: torch.device | str = "cuda",
                 remat: bool = True):
        """``remat``: recompute each layer in ``train_loss``'s backward
        pass instead of keeping its activations (the reference's
        ``Rules.remat``, on by default); the gradients are the same."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.remat = remat

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
        [L, 8192, 29568] one)."""
        dtype = dtype or self.compute_dtype

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=self.device)

        def draw(init: tuple, shape) -> torch.Tensor:
            kind = init[0]
            if kind == "ones":
                return torch.ones(shape, device=self.device)
            if kind == "zeros":
                return torch.zeros(shape, device=self.device)
            if kind == "a_log":  # A uniform in [1, 16] (Mamba2 default)
                return torch.log(uniform(shape, 1.0, 16.0))
            if kind == "dt_bias":
                # dt log-uniform in [1e-3, 1e-1], stored as inverse softplus
                dt = torch.exp(uniform(shape, math.log(1e-3), math.log(1e-1)))
                return dt + torch.log(-torch.expm1(-dt))
            return torch.randn(shape, generator=generator,
                               device=self.device).mul_(init[1])

        def fill(out: torch.Tensor, init: tuple) -> None:
            rows = _INIT_PART * out.shape[0] // out.numel()
            if rows:
                for part in out.split(rows):
                    part.copy_(draw(init, part.shape))
                return
            for row in out:
                fill(row, init)

        def make(leaf: Leaf) -> torch.Tensor:
            out = torch.empty(leaf.shape, device=self.device,
                              dtype=torch.float32 if leaf.fp32 else dtype)
            fill(out, leaf.init)
            return out

        return map_schema(make, param_schema(self.cfg))

    def init_like(self, *, dtype: torch.dtype | None = None) -> dict:
        """``init``'s tree as meta tensors (names, shapes and dtypes, no
        memory): what a checkpoint restore is asked to fill."""
        dtype = dtype or self.compute_dtype

        def make(leaf: Leaf) -> torch.Tensor:
            return torch.empty(leaf.shape, device="meta",
                               dtype=torch.float32 if leaf.fp32 else dtype)

        return map_schema(make, param_schema(self.cfg))

    def serving_params(self, params: dict) -> dict:
        """``params`` (fp32 masters, or a serving tree) as ``init`` makes
        them for serving, on the model's device: every leaf in the compute
        dtype, ``Leaf.fp32`` ones in fp32. A master is rounded once, as
        the reference rounds it at each use."""
        def cast(leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
            return t.to(self.device, torch.float32 if leaf.fp32
                        else self.compute_dtype)

        return map_schema(cast, param_schema(self.cfg), params)

    def count_params(self) -> int:
        sizes = []
        map_schema(lambda leaf: sizes.append(math.prod(leaf.shape)),
                   param_schema(self.cfg))
        return sum(sizes)

    # ----- layers -----

    def _qkv(self, p: dict, a: torch.Tensor):
        cfg = self.cfg
        b, s, _ = a.shape
        dt = a.dtype
        q = a @ p["wq"].to(dt)
        k = a @ p["wk"].to(dt)
        v = a @ p["wv"].to(dt)
        if cfg.qkv_bias:
            q = q + p["bq"].to(dt)
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
                k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
                v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))

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
                   mrope_pos: torch.Tensor | None = None):
        """The attention sublayer over a whole sequence (prefill, train):
        returns (h + attention, k, v), k/v after RoPE for the cache. The
        causal mask is the kernel's, over the 1-D ``positions``, whatever
        ``mrope_pos`` rotates by, as in the reference."""
        cfg = self.cfg
        b, s, _ = h.shape
        a = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = self._qkv(p, a)
        q = self._rope(q, positions, mrope_pos)
        k = self._rope(k, positions, mrope_pos)
        out = attention_op(q, k, v, causal=True, window=cfg.sliding_window)
        return h + out.reshape(b, s, -1) @ p["wo"].to(h.dtype), k, v

    def _train_layer(self, kind: str, p: dict, h: torch.Tensor,
                     positions: torch.Tensor,
                     mrope_pos: torch.Tensor | None = None):
        """One entry of ``_schedule`` over a whole sequence, no caches.
        Returns (h, the MoE block's aux, or None without one)."""
        if kind == "mamba":
            return self.mamba_sublayer(p, h, None, mode="train"), None
        h = self._attention(p, h, positions, mrope_pos)[0]
        return self._mlp(p, h) if "mlp_norm" in p else (h, None)

    def _mlp(self, p: dict, h: torch.Tensor):
        """The MLP sublayer, SwiGLU or, with ``cfg.moe``, the MoE block
        over every token of the call. Returns (h, aux or None)."""
        m = L.rms_norm(h, p["mlp_norm"], self.cfg.norm_eps)
        if self.cfg.moe:
            y, aux = moe_lib.moe_block(m, p["router"], p["w_gate"], p["w_up"],
                                       p["w_down"], moe=self.cfg.moe)
            return h + y, aux
        return h + L.swiglu(m, p["w_gate"], p["w_up"], p["w_down"]), None

    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """The first layer's input: ``batch["embeddings"]`` [B, S, D] (a
        frontend's output, fp32) cast to the compute dtype before any
        layer, as the reference casts it, or else the embedding rows of
        ``batch["tokens"]`` [B, S]."""
        if "embeddings" in batch:
            return batch["embeddings"].to(self.compute_dtype)
        return L.embed(batch["tokens"].long(), params["embed"],
                       self.compute_dtype)

    def _logits(self, params: dict, h: torch.Tensor,
                unembed: torch.Tensor | None) -> torch.Tensor:
        h = L.rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        if unembed is None:
            unembed = self.unembed_table(params)
        return L.unembed(h, unembed)

    def unembed_table(self, params: dict) -> torch.Tensor:
        """The unembedding table [d, V] in fp32, made from ``params`` now.
        The entry points take it as ``unembed=`` so that a caller who
        unembeds often (the serving engine) upcasts the table once per set
        of weights, not on every call (151936 x 2048 at full width)."""
        table = (params["embed"].T if self.cfg.tie_embeddings
                 else params["lm_head"])
        # fp32 masters round to the compute dtype first, as the reference's
        # unembed casts the table to the activations' dtype
        return table.to(self.compute_dtype).float()

    def mamba_sublayer(self, p: dict, h: torch.Tensor, cache: dict | None,
                       *, mode: str) -> torch.Tensor:
        """One Mamba2 block: the reference's ``mamba_sublayer``. ``mode`` is
        "train" (no caches: ``cache`` is None, the final state is dropped
        and nothing is written), "prefill" (from zero states) or "decode"
        (one token); the last two write the new states into ``cache``, this
        layer's views of the SSM caches, in place. Each projection is cast
        to h's dtype where it is used, as the reference casts it. Returns h
        with the block's output added."""
        cfg, s_cfg = self.cfg, self.cfg.ssm
        b, s, d = h.shape
        di = s_cfg.expand * d
        nh, pd = di // s_cfg.head_dim, s_cfg.head_dim
        g, n = s_cfg.ngroups, s_cfg.state_dim
        dtc = h.dtype
        a = L.rms_norm(h, p["norm"], cfg.norm_eps)
        z = a @ p["z_proj"].to(dtc)
        x = a @ p["x_proj"].to(dtc)
        Bm = a @ p["B_proj"].to(dtc)
        Cm = a @ p["C_proj"].to(dtc)
        dtr = a @ p["dt_proj"].to(dtc)
        A = -torch.exp(p["A_log"])
        if mode in ("train", "prefill"):
            x, cx = ssm_lib.causal_conv(x, p["conv_x_w"], p["conv_x_b"])
            Bm, cb = ssm_lib.causal_conv(Bm, p["conv_B_w"], p["conv_B_b"])
            Cm, cc = ssm_lib.causal_conv(Cm, p["conv_C_w"], p["conv_C_b"])
            dt = F.softplus(dtr.float() + p["dt_bias"])
            y, state = ssd_op(x.reshape(b, s, nh, pd), dt, A,
                              Bm.reshape(b, s, g, n), Cm.reshape(b, s, g, n),
                              p["ssm_D"], chunk=s_cfg.chunk_size)
            y = y.reshape(b, s, di)
        elif mode == "decode":
            x1, cx = ssm_lib.conv_decode_step(cache["conv_x"], x[:, 0],
                                              p["conv_x_w"], p["conv_x_b"])
            B1, cb = ssm_lib.conv_decode_step(cache["conv_B"], Bm[:, 0],
                                              p["conv_B_w"], p["conv_B_b"])
            C1, cc = ssm_lib.conv_decode_step(cache["conv_C"], Cm[:, 0],
                                              p["conv_C_w"], p["conv_C_b"])
            dt1 = F.softplus(dtr[:, 0].float() + p["dt_bias"])
            y1, state = ssm_lib.ssd_decode_step(
                cache["ssm"], x1.reshape(b, nh, pd), dt1, A,
                B1.reshape(b, g, n), C1.reshape(b, g, n), p["ssm_D"])
            y = y1.reshape(b, 1, di)
        else:
            raise ValueError(f"mamba_sublayer: mode {mode!r}")
        if mode != "train":
            for name, new in (("ssm", state), ("conv_x", cx), ("conv_B", cb),
                              ("conv_C", cc)):
                cache[name].copy_(new)
        gated = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
        return h + gated @ p["out_proj"].to(dtc)

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
        if "k" in caches:
            # Ring slot g holds position p0 + (g - p0) mod w, p0 = max(0,
            # s - w): the last w positions; slots past the prompt stay
            # empty (-1, zeros). The filled slots are the first min(s, w),
            # known on the host: no data-dependent shape, no read back.
            w = self.cache_window(cache_len)
            p0 = max(0, s - w)
            slots = torch.arange(min(s, w), device=self.device)
            src = p0 + torch.remainder(slots - p0, w)
            caches["slot_pos"][:, slots] = src.to(torch.int32)
        for kind, p, i in self._schedule(params):
            if kind == "mamba":
                h = self.mamba_sublayer(p, h, _views(caches, SSM_CACHE, i),
                                        mode="prefill")
                continue
            h, k, v = self._attention(p, h, positions, mrope_pos)
            caches["k"][i][:, slots] = k[:, src]
            caches["v"][i][:, slots] = v[:, src]
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
        cfg = self.cfg
        h = L.embed(tokens.long(), params["embed"], self.compute_dtype)
        b = h.shape[0]
        positions = torch.arange(pos, pos + 1, device=self.device)
        mrope_pos = (torch.full((b, 1, 3), pos, dtype=torch.int32,
                                device=self.device) if cfg.mrope else None)
        for kind, p, i in self._schedule(params):
            if kind == "mamba":
                h = self.mamba_sublayer(p, h, _views(caches, SSM_CACHE, i),
                                        mode="decode")
                continue
            a = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
            q, k, v = self._qkv(p, a)
            q = self._rope(q, positions, mrope_pos)
            k = self._rope(k, positions, mrope_pos)
            layer_cache = _views(caches, KV_CACHE, i)
            attn.cache_append(layer_cache, k, v, pos)
            out = attn.decode_attention(
                q, layer_cache["k"], layer_cache["v"],
                layer_cache["slot_pos"], pos, window=cfg.sliding_window)
            h = h + out.reshape(b, 1, -1) @ p["wo"].to(h.dtype)
            if "mlp_norm" in p:
                h = self._mlp(p, h)[0]
        return self._logits(params, h, unembed)[:, 0], caches

    # ----- training -----

    def _layer_params(self, params: dict) -> list[dict]:
        """Each layer's parameters: ``params["layers"]`` as stacked [L, ...]
        leaves, sliced, or already a list of per-layer dicts (the training
        step's leaf views, ``repro_torch.train.step``)."""
        layers = params["layers"]
        if isinstance(layers, (list, tuple)):
            return list(layers)
        return [{name: t[i] for name, t in layers.items()}
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
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
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
                aux = aux + aux_i
        return h, aux / self.cfg.num_layers

    def train_loss(self, params: dict, batch: dict):
        """batch: tokens [B, S] or embeddings [B, S, D] (fp32; the
        ``embed`` leaf then takes no gradient), optional mrope_pos
        [B, S, 3], and labels [B, S]. Returns (loss, {"ce", "aux"}):
        ce, the mean over positions of logsumexp(logits) - logits[label]
        on fp32 logits of the whole sequence, plus, with ``cfg.moe``,
        ``router_aux_weight`` times the layers' mean load-balance aux, as
        the reference's ``train_loss``. The masters are cast to the
        compute dtype where they are used, inside each (checkpointed)
        layer, so remat keeps no copies of them."""
        labels = batch["labels"].long()
        h = self._embed_inputs(params, batch)
        positions = torch.arange(h.shape[1], device=h.device)
        h, aux = self.apply_layers(params, h, mode="train",
                                   positions=positions,
                                   mrope_pos=batch.get("mrope_pos"))
        logits = self._logits(params, h, None)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels[..., None])[..., 0]
        ce = (lse - label_logit).mean()
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
        state or k/v leaf is in the compute dtype."""
        def make(name, shape):
            if name == "slot_pos":
                return torch.full(shape, -1, dtype=torch.int32,
                                  device=self.device)
            return torch.zeros(shape, device=self.device,
                               dtype=torch.float32 if name == "ssm"
                               else self.compute_dtype)

        return {name: make(name, shape) for name, shape in
                self.cache_shapes(batch, cache_len).items()}


def _views(caches: dict, names: tuple[str, ...], i: int) -> dict:
    """Entry i of the stacked caches ``names``: views, written in place."""
    return {name: caches[name][i] for name in names}
