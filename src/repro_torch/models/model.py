"""The decoder-only LM in PyTorch, dense and SSM (Mamba2) families: the
counterpart of those paths of the JAX package's ``models/model.py``.

Parameters keep the reference's names, shapes and ``x @ W`` orientation:
stacked ``[L, ...]`` leaves under ``params["layers"]`` (``wq`` is
``[L, d, nq * hd]``, not ``nn.Linear``'s ``[out, in]``), so a checkpoint
can name its entries the same way in both packages. The layer loop is a
Python loop over the views ``layers[name][i]``.

The reference keeps fp32 masters and casts each to the compute dtype where
it is used. For serving, a parameter the reference only uses in the
compute dtype is cast once, when it is made or loaded: the same bits at
half the memory. For training, ``init(..., dtype=torch.float32)`` keeps
fp32 masters and every use casts, as the reference does. The SSM leaves
the reference uses in fp32 (``A_log``, ``ssm_D``, ``dt_bias``, the conv
weights and biases: ``Leaf.fp32``) stay fp32 and are cast where the
reference casts them.

Three entry points, matching the reference's:
  ``prefill``      fills the caches (a ring KV cache for the dense family,
                   the SSM and conv states for Mamba2), returns last-token
                   fp32 logits;
  ``decode_step``  one new token against those caches, updated in place;
  ``train_loss``   mean cross-entropy of full-sequence fp32 logits, dense
                   family only, each layer recomputed in the backward pass
                   (``remat``) as under the reference's ``Rules.remat``.
"""

from __future__ import annotations

import math
from collections import namedtuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import attention_op, ssd_op
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib

# init is ("normal", std), ("ones",), ("zeros",), ("a_log",) or
# ("dt_bias",); fp32: kept in fp32 whatever the compute dtype
Leaf = namedtuple("Leaf", ["shape", "init", "fp32"], defaults=(False,))

PORTED_ARCH_TYPES = ("dense", "ssm")


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
    names."""
    schema = {"embed": Leaf((cfg.vocab_size, cfg.d_model), ("normal", 0.02)),
              "final_norm": Leaf((cfg.d_model,), ("ones",))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size),
                                 ("normal", 0.02))
    if cfg.arch_type == "ssm":
        schema["layers"] = _ssm_leaves(cfg)
    else:
        schema["layers"] = _dense_leaves(cfg)
    return schema


def _dense_leaves(cfg: ModelConfig) -> dict:
    """The reference's ``_attn_leaves`` and dense ``_mlp_leaves``."""
    d, f = cfg.d_model, cfg.d_ff
    hd, nq, nkv, n = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    s_in = ("normal", 0.02)
    s_out = ("normal", 0.02 / math.sqrt(2 * n))
    layers = {
        "attn_norm": Leaf((n, d), ("ones",)),
        "wq": Leaf((n, d, nq * hd), s_in),
        "wk": Leaf((n, d, nkv * hd), s_in),
        "wv": Leaf((n, d, nkv * hd), s_in),
        "wo": Leaf((n, nq * hd, d), s_out),
    }
    if cfg.qkv_bias:
        layers["bq"] = Leaf((n, nq * hd), ("zeros",))
        layers["bk"] = Leaf((n, nkv * hd), ("zeros",))
        layers["bv"] = Leaf((n, nkv * hd), ("zeros",))
    layers.update({
        "mlp_norm": Leaf((n, d), ("ones",)),
        "w_gate": Leaf((n, d, f), s_in),
        "w_up": Leaf((n, d, f), s_in),
        "w_down": Leaf((n, f, d), s_out),
    })
    return layers


class Model:
    def __init__(self, cfg: ModelConfig, *, device: torch.device | str = "cuda",
                 remat: bool = True):
        """``remat``: recompute each layer in ``train_loss``'s backward
        pass instead of keeping its activations (the reference's
        ``Rules.remat``, on by default); the gradients are the same."""
        if cfg.arch_type not in PORTED_ARCH_TYPES or cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: arch_type {cfg.arch_type!r}"
                f"{' with MoE' if cfg.moe else ''} is not ported yet; the "
                f"port serves {PORTED_ARCH_TYPES} without MoE only "
                "(ROADMAP.md, queue A)")
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
        numbers."""
        dtype = dtype or self.compute_dtype
        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=self.device)

        def make(leaf: Leaf) -> torch.Tensor:
            kind = leaf.init[0]
            if kind == "ones":
                t = torch.ones(leaf.shape, device=self.device)
            elif kind == "zeros":
                t = torch.zeros(leaf.shape, device=self.device)
            elif kind == "a_log":  # A uniform in [1, 16] (Mamba2 default)
                t = torch.log(uniform(leaf.shape, 1.0, 16.0))
            elif kind == "dt_bias":
                # dt log-uniform in [1e-3, 1e-1], stored as inverse softplus
                dt = torch.exp(uniform(leaf.shape, math.log(1e-3),
                                       math.log(1e-1)))
                t = dt + torch.log(-torch.expm1(-dt))
            else:
                t = torch.randn(leaf.shape, generator=generator,
                                device=self.device) * leaf.init[1]
            return t if leaf.fp32 else t.to(dtype)

        schema = param_schema(self.cfg)
        params = {k: make(v) for k, v in schema.items() if k != "layers"}
        params["layers"] = {k: make(v) for k, v in schema["layers"].items()}
        return params

    def count_params(self) -> int:
        schema = param_schema(self.cfg)
        leaves = list(schema["layers"].values()) + [
            v for k, v in schema.items() if k != "layers"]
        return sum(math.prod(leaf.shape) for leaf in leaves)

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

    def _attention(self, p: dict, h: torch.Tensor, positions: torch.Tensor):
        """The attention sublayer over a whole sequence (prefill, train):
        returns (h + attention, k, v), k/v after RoPE for the cache."""
        cfg = self.cfg
        b, s, _ = h.shape
        a = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = self._qkv(p, a)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out = attention_op(q, k, v, causal=True, window=cfg.sliding_window)
        return h + out.reshape(b, s, -1) @ p["wo"].to(h.dtype), k, v

    def _train_layer(self, p: dict, h: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        return self._mlp(p, self._attention(p, h, positions)[0])

    def _mlp(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        m = L.rms_norm(h, p["mlp_norm"], self.cfg.norm_eps)
        return h + L.swiglu(m, p["w_gate"], p["w_up"], p["w_down"])

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

    def mamba_sublayer(self, p: dict, h: torch.Tensor, cache: dict, *,
                       decode: bool) -> torch.Tensor:
        """One Mamba2 block: the reference's ``mamba_sublayer``. ``cache``
        holds this layer's views of the SSM caches; the prefill (``decode``
        false, from zero states) and the one-token decode write the new
        states into them in place. Returns h with the block's output added."""
        cfg, s_cfg = self.cfg, self.cfg.ssm
        b, s, d = h.shape
        di = s_cfg.expand * d
        nh, pd = di // s_cfg.head_dim, s_cfg.head_dim
        g, n = s_cfg.ngroups, s_cfg.state_dim
        a = L.rms_norm(h, p["norm"], cfg.norm_eps)
        z = a @ p["z_proj"]
        x = a @ p["x_proj"]
        Bm = a @ p["B_proj"]
        Cm = a @ p["C_proj"]
        dtr = a @ p["dt_proj"]
        A = -torch.exp(p["A_log"])
        if not decode:
            x, cx = ssm_lib.causal_conv(x, p["conv_x_w"], p["conv_x_b"])
            Bm, cb = ssm_lib.causal_conv(Bm, p["conv_B_w"], p["conv_B_b"])
            Cm, cc = ssm_lib.causal_conv(Cm, p["conv_C_w"], p["conv_C_b"])
            dt = F.softplus(dtr.float() + p["dt_bias"])
            y, state = ssd_op(x.reshape(b, s, nh, pd), dt, A,
                              Bm.reshape(b, s, g, n), Cm.reshape(b, s, g, n),
                              p["ssm_D"], chunk=s_cfg.chunk_size)
            y = y.reshape(b, s, di)
        else:
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
        for name, new in (("ssm", state), ("conv_x", cx), ("conv_B", cb),
                          ("conv_C", cc)):
            cache[name].copy_(new)
        gated = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
        return h + gated @ p["out_proj"]

    def _mamba_layers(self, params: dict, h: torch.Tensor, caches: dict, *,
                      decode: bool) -> torch.Tensor:
        layers = params["layers"]
        for i in range(self.cfg.num_layers):
            p = {name: t[i] for name, t in layers.items()}
            layer_cache = {name: t[i] for name, t in caches.items()}
            h = self.mamba_sublayer(p, h, layer_cache, decode=decode)
        return h

    # ----- entry points -----

    def prefill(self, params: dict, batch: dict, *, cache_len: int,
                unembed: torch.Tensor | None = None):
        """Fill caches for ``batch["tokens"]`` [B, S]; ``unembed`` is
        ``unembed_table(params)``, made here if not given. The SSM family
        builds no ring and ignores ``cache_len``, as the reference does.
        Returns (last_logits [B, V] fp32, caches)."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        h = L.embed(tokens, params["embed"], self.compute_dtype)
        if cfg.arch_type == "ssm":
            caches = self.init_cache(b, cache_len)
            h = self._mamba_layers(params, h, caches, decode=False)
            return self._logits(params, h[:, -1:], unembed)[:, 0], caches
        positions = torch.arange(s, device=self.device)
        w = self.cache_window(cache_len)
        caches = self.init_cache(b, cache_len)
        # Ring slot g holds position p0 + (g - p0) mod w, p0 = max(0, s - w):
        # the last w positions; slots past the prompt stay empty (-1, zeros).
        p0 = max(0, s - w)
        src = p0 + torch.remainder(torch.arange(w, device=self.device) - p0, w)
        valid = src < s
        slots, src = valid.nonzero()[:, 0], src[valid]
        caches["slot_pos"][:, slots] = src.to(torch.int32)
        for i, p in enumerate(self._layer_params(params)):
            h, k, v = self._attention(p, h, positions)
            caches["k"][i][:, slots] = k[:, src]
            caches["v"][i][:, slots] = v[:, src]
            h = self._mlp(p, h)
        return self._logits(params, h[:, -1:], unembed)[:, 0], caches

    def decode_step(self, params: dict, tokens: torch.Tensor, caches: dict,
                    pos: int, *, unembed: torch.Tensor | None = None):
        """One token: tokens [B, 1]; pos, the absolute position; ``unembed``
        as in ``prefill``.
        Writes the token's k/v (or SSM and conv states) into ``caches`` in
        place (the reference donates the cache buffer) and returns
        (logits [B, V] fp32, caches)."""
        cfg = self.cfg
        h = L.embed(tokens.long(), params["embed"], self.compute_dtype)
        if cfg.arch_type == "ssm":
            h = self._mamba_layers(params, h, caches, decode=True)
            return self._logits(params, h, unembed)[:, 0], caches
        b = h.shape[0]
        positions = torch.tensor([pos], device=self.device)
        for i, p in enumerate(self._layer_params(params)):
            a = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
            q, k, v = self._qkv(p, a)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            layer_cache = {name: caches[name][i]
                           for name in ("k", "v", "slot_pos")}
            attn.cache_append(layer_cache, k, v, pos)
            out = attn.decode_attention(
                q, layer_cache["k"], layer_cache["v"],
                layer_cache["slot_pos"], pos, window=cfg.sliding_window)
            h = h + out.reshape(b, 1, -1) @ p["wo"].to(h.dtype)
            h = self._mlp(p, h)
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
                     positions: torch.Tensor):
        """The dense layer stack over a whole sequence without caches, as
        the reference's ``apply_layers(mode="train")``, with each layer
        checkpointed when ``remat``. Returns (h, aux_mean): aux is 0 for
        the dense family. ``prefill`` and ``decode_step`` run their own
        loops, which write the caches."""
        if mode != "train":
            raise ValueError(f"apply_layers: mode {mode!r}; only 'train' runs "
                             "here (prefill and decode_step have their own "
                             "loops)")
        for p in self._layer_params(params):
            if self.remat:
                h = checkpoint(self._train_layer, p, h, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = self._train_layer(p, h, positions)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def train_loss(self, params: dict, batch: dict):
        """batch: tokens and labels [B, S]. Returns (loss, {"ce", "aux"}):
        the mean over positions of logsumexp(logits) - logits[label] on
        fp32 logits of the whole sequence, as the reference's
        ``train_loss``. The masters are cast to the compute dtype where
        they are used, inside each (checkpointed) layer, so remat keeps no
        copies of them. Dense family without MoE only, on every device."""
        cfg = self.cfg
        if cfg.arch_type != "dense" or cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: training is ported for the dense family "
                f"without MoE only, not arch_type {cfg.arch_type!r}"
                f"{' with MoE' if cfg.moe else ''} (ROADMAP.md A.5, A.6, "
                "A.11)")
        tokens = batch["tokens"].long()
        labels = batch["labels"].long()
        h = L.embed(tokens, params["embed"], self.compute_dtype)
        positions = torch.arange(tokens.shape[1], device=h.device)
        h, aux = self.apply_layers(params, h, mode="train",
                                   positions=positions)
        logits = self._logits(params, h, None)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels[..., None])[..., 0]
        ce = (lse - label_logit).mean()
        return ce, {"ce": ce, "aux": aux}

    # ----- caches -----

    def cache_window(self, cache_len: int) -> int:
        """Physical cache length: the sliding window bounds it if set."""
        sw = self.cfg.sliding_window
        return sw if sw and sw < cache_len else cache_len

    def cache_shapes(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        if cfg.arch_type == "ssm":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            gn = s.ngroups * s.state_dim
            conv = (cfg.num_layers, batch, s.conv_width - 1)
            return {"ssm": (cfg.num_layers, batch, di // s.head_dim,
                            s.head_dim, s.state_dim),
                    "conv_x": conv + (di,), "conv_B": conv + (gn,),
                    "conv_C": conv + (gn,)}
        w = self.cache_window(cache_len)
        kv = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        return {"k": kv, "v": kv, "slot_pos": (cfg.num_layers, w)}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zero caches (slot_pos -1); the SSM state is fp32, every other
        state or k/v leaf is in the compute dtype."""
        shapes = self.cache_shapes(batch, cache_len)
        if self.cfg.arch_type == "ssm":
            return {name: torch.zeros(
                shape, device=self.device,
                dtype=torch.float32 if name == "ssm" else self.compute_dtype)
                for name, shape in shapes.items()}
        return {
            "k": torch.zeros(shapes["k"], dtype=self.compute_dtype,
                             device=self.device),
            "v": torch.zeros(shapes["v"], dtype=self.compute_dtype,
                             device=self.device),
            "slot_pos": torch.full(shapes["slot_pos"], -1, dtype=torch.int32,
                                   device=self.device),
        }
