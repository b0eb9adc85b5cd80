"""The dense decoder-only LM in PyTorch: the counterpart of the dense path
of the JAX package's ``models/model.py``.

Parameters keep the reference's names, shapes and ``x @ W`` orientation:
stacked ``[L, ...]`` leaves under ``params["layers"]`` (``wq`` is
``[L, d, nq * hd]``, not ``nn.Linear``'s ``[out, in]``), so a checkpoint
can name its entries the same way in both packages. The layer loop is a
Python loop over the views ``layers[name][i]``.

The reference keeps fp32 masters and casts each to the compute dtype where
it is used; here every parameter is cast once, when it is made or loaded.
The result is the same, bit for bit, at half the memory.

Two entry points, matching the reference's serving path:
  ``prefill``      fills the ring KV cache, returns last-token fp32 logits;
  ``decode_step``  one new token against that cache, updated in place.
"""

from __future__ import annotations

import math
from collections import namedtuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import attention_op
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

# init is ("normal", std), ("ones",) or ("zeros",)
Leaf = namedtuple("Leaf", ["shape", "init"])


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises rather than carry on without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def param_schema(cfg: ModelConfig) -> dict:
    """Shapes and initialisers of the dense family's parameters, under the
    reference's names."""
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
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
    schema = {"embed": Leaf((v, d), s_in), "final_norm": Leaf((d,), ("ones",))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = Leaf((d, v), s_in)
    schema["layers"] = layers
    return schema


class Model:
    def __init__(self, cfg: ModelConfig, *, device: torch.device | str = "cuda"):
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet; "
                "the port serves the dense family only (ROADMAP.md, queue A)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.dtype)

    # ----- params -----

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in the compute dtype, drawn on the model's device
        from ``generator`` (which must live there too): the reference's
        distributions, not its numbers."""
        def make(leaf: Leaf) -> torch.Tensor:
            kind = leaf.init[0]
            if kind == "ones":
                t = torch.ones(leaf.shape, device=self.device)
            elif kind == "zeros":
                t = torch.zeros(leaf.shape, device=self.device)
            else:
                t = torch.randn(leaf.shape, generator=generator,
                                device=self.device) * leaf.init[1]
            return t.to(self.compute_dtype)

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
        q = a @ p["wq"]
        k = a @ p["wk"]
        v = a @ p["wv"]
        if cfg.qkv_bias:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]
        return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
                k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
                v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))

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
        if self.cfg.tie_embeddings:
            return params["embed"].T.float()
        return params["lm_head"].float()

    # ----- entry points -----

    def prefill(self, params: dict, batch: dict, *, cache_len: int,
                unembed: torch.Tensor | None = None):
        """Fill caches for ``batch["tokens"]`` [B, S]; ``unembed`` is
        ``unembed_table(params)``, made here if not given.
        Returns (last_logits [B, V] fp32, caches)."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        h = L.embed(tokens, params["embed"], self.compute_dtype)
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
        layers = params["layers"]
        for i in range(cfg.num_layers):
            p = {name: t[i] for name, t in layers.items()}
            a = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
            q, k, v = self._qkv(p, a)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            out = attention_op(q, k, v, causal=True, window=cfg.sliding_window)
            caches["k"][i][:, slots] = k[:, src]
            caches["v"][i][:, slots] = v[:, src]
            h = h + out.reshape(b, s, -1) @ p["wo"]
            h = self._mlp(p, h)
        return self._logits(params, h[:, -1:], unembed)[:, 0], caches

    def decode_step(self, params: dict, tokens: torch.Tensor, caches: dict,
                    pos: int, *, unembed: torch.Tensor | None = None):
        """One token: tokens [B, 1]; pos, the absolute position; ``unembed``
        as in ``prefill``.
        Writes the token's k/v into ``caches`` in place (the reference
        donates the cache buffer) and returns (logits [B, V] fp32, caches)."""
        cfg = self.cfg
        h = L.embed(tokens.long(), params["embed"], self.compute_dtype)
        b = h.shape[0]
        positions = torch.tensor([pos], device=self.device)
        layers = params["layers"]
        for i in range(cfg.num_layers):
            p = {name: t[i] for name, t in layers.items()}
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
            h = h + out.reshape(b, 1, -1) @ p["wo"]
            h = self._mlp(p, h)
        return self._logits(params, h, unembed)[:, 0], caches

    # ----- caches -----

    def cache_window(self, cache_len: int) -> int:
        """Physical cache length: the sliding window bounds it if set."""
        sw = self.cfg.sliding_window
        return sw if sw and sw < cache_len else cache_len

    def cache_shapes(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        w = self.cache_window(cache_len)
        kv = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        return {"k": kv, "v": kv, "slot_pos": (cfg.num_layers, w)}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        shapes = self.cache_shapes(batch, cache_len)
        return {
            "k": torch.zeros(shapes["k"], dtype=self.compute_dtype,
                             device=self.device),
            "v": torch.zeros(shapes["v"], dtype=self.compute_dtype,
                             device=self.device),
            "slot_pos": torch.full(shapes["slot_pos"], -1, dtype=torch.int32,
                                   device=self.device),
        }
