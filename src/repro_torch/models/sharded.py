"""The model on a ``DeviceMesh``: every parameter, cache and activation a
DTensor with the reference's placements (``sharding/rules.py``), the
counterpart of the JAX model's GSPMD constraints and ``shard_map`` islands.

``Model(cfg, make_rules(mesh))`` runs here; one process per device, each
holding its shards. The layer code is ``models/model.py``'s, on DTensors:
``ShardedPath`` supplies the operations it leaves to where it runs
(``PlainOps`` on one device):
  * Norms, RoPE's inputs, residual adds and elementwise work are DTensor
    ops. A reduction over a sharded dim (the Mamba2 gated norm over
    ``d_inner``) gives a partial result that DTensor sums before the
    non-linear op after it, so it is the reference's.
  * Each matmul is ``mm``: the activation is redistributed to the layout
    the weight's use placements need (a weight is gathered over the data
    axes where it is used, FSDP: ``use``), and the product runs on the
    local shards, giving a sharded or a partial output.
  * Where the reference calls ``rules.constrain``, the port calls
    ``redistribute`` to the same spec (``put``).
  * Every place the reference has a ``shard_map``, and every kernel call,
    is a ``local_map`` island whose body runs on local tensors, with
    functional collectives where the reference's body has them:
      - sequence-sharded attention: q keeps its rows of the model shard, K
        and V are gathered over ``model`` (their gradients reduce-scattered
        back), the body calls ``attention_op(q_offset=i * S / tp)``, and
        with a cache each shard writes its own rows of the ring, by the
        reference's slot rule;
      - the decode: the token's k/v go to the shard that owns its slot,
        then an all-reduce MAX of the row maxima and SUM of ``l`` and ``o``
        over ``cache_axes`` (``Model._decode_attend``, whose one-device
        case is the plain path's);
      - the Mamba2 conv and SSD scan on the rank's heads (``ssm_mix``), B
        and C replicated (their gradients are partial sums, summed by
        DTensor);
      - the MoE block, ``tp`` or ``ep`` (``models/moe.py``): the partial
        outputs summed over ``reduce_axes`` (tp) or ``model`` (ep), the aux
        averaged over the data axes;
      - the vocab-sharded embedding lookup and cross-entropy: each rank
        looks up or scores its vocab rows; the max over the vocab is an
        all-reduce MAX, the sums partial results that DTensor sums. The
        fp32 logits are never gathered for the loss.
    An island's gradient placements say which of its inputs' gradients
    are partial sums across ranks.

Gradients reach the parameters through per-layer DTensor views of the
stacked leaves (``view_of``); ``train/step.py`` adds each view's
gradient into the stacked buffer as it arrives.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ops import attention_op
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import (_mesh_device, init_parts, map_schema,
                                      param_schema, ssm_mix)

# the Mamba2 block's fp32 leaves the scan island takes, in its order
_SSM_WEIGHTS = ("conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b", "conv_C_w",
                "conv_C_b", "dt_bias", "A_log", "ssm_D")


def _intersect(index: tuple, mine: tuple):
    """Where part ``index`` (ints, then a slice, then whole dims) meets the
    slices ``mine``: (the part's sub-index, the local index), or None."""
    src, dst = [], []
    for dim, sl in enumerate(mine):
        at = index[dim] if dim < len(index) else slice(None)
        if isinstance(at, int):
            if not sl.start <= at < sl.stop:
                return None
            dst.append(at - sl.start)
            continue
        lo = sl.start if at.start is None else max(at.start, sl.start)
        hi = sl.stop if at.stop is None else min(at.stop, sl.stop)
        if lo >= hi:
            return None
        base = 0 if at.start is None else at.start
        src.append(slice(lo - base, hi - base))
        dst.append(slice(lo - sl.start, hi - sl.start))
    return tuple(src), tuple(dst)


def shard_params(params: dict, rules, cfg) -> dict:
    """Full parameters (a tree of tensors, the same on every rank, e.g.
    from ``params_from_numpy``) as DTensors with the specs' placements:
    each rank keeps only its slice, copied to its device."""
    dev = _mesh_device(rules.mesh)

    def put(leaf, t):
        local = t[rules.local_slices(leaf.shape, leaf.spec)]
        return rules.from_local(local.to(dev).contiguous(), leaf.spec,
                                leaf.shape)

    return map_schema(put, param_schema(cfg, rules), params)


def _shift(placements, by: int = 1) -> list:
    """Placements of a view that drops the leading ``by`` dims (which no
    placement shards)."""
    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim < by:
                raise ValueError("a view cannot drop a sharded dim")
            out.append(Shard(p.dim - by))
        else:
            out.append(p)
    return out


def view_of(t: DTensor, i: int) -> DTensor:
    """Entry i of a stacked DTensor (its first dim unsharded): a DTensor
    view of the local storage, no communication."""
    local = t.to_local()[i]
    return DTensor.from_local(local, t.device_mesh, _shift(t.placements),
                              run_check=False, shape=t.shape[1:],
                              stride=local.stride())


class ShardedPath:
    """``PlainOps``'s methods on a mesh (see the module docstring)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.r = model.rules
        self.mesh = self.r.mesh
        names = self.r.axis_names
        self.mdim = names.index(self.r.model_axis)
        self.ddims = [names.index(a) for a in self.r.data_axes]

    # ----- helpers -----

    def _pl(self, spec) -> list:
        return self.r.placements(spec)

    def put(self, x: DTensor, spec) -> DTensor:
        """The reference's ``rules.constrain``."""
        return self._redistribute(x, self._pl(spec))

    def _redistribute(self, x: DTensor, placements) -> DTensor:
        """``x.redistribute`` to ``placements``, a mesh dim that moves its
        shard from one tensor dim to another by one all-to-all (as XLA
        moves it; DTensor's own falls back to an all-gather on a CPU mesh)."""
        for m, (cur, want) in enumerate(zip(x.placements, placements)):
            if (isinstance(cur, Shard) and isinstance(want, Shard)
                    and cur.dim != want.dim):
                x = self._all_to_all(x, m, want.dim)
        return x.redistribute(self.mesh, list(placements))

    def _all_to_all(self, x: DTensor, m: int, dst: int) -> DTensor:
        """``x``, sharded on some dim over mesh dim ``m``, sharded on dim
        ``dst`` instead: each rank sends the i-th chunk of its ``dst`` dim
        to rank i and joins what it receives along its old dim."""
        n = self.mesh.size(m)
        pl = list(x.placements)
        src = pl[m].dim
        out = pl.copy()
        out[m] = Shard(dst)
        if n == 1:
            return x.redistribute(self.mesh, out)
        group = (self.mesh, m)

        def body(t):
            send = torch.stack(t.chunk(n, dim=dst)).contiguous()
            recv = funcol.all_to_all_single_autograd(
                send.flatten(), [send[0].numel()] * n,
                [send[0].numel()] * n, group)
            recv = funcol.wait_tensor(recv).view(send.shape)
            return torch.cat(recv.unbind(0), dim=src)

        return self._island(body, out, (pl,), (pl,))(x)

    def _island(self, fn, out, ins, grads=None):
        """``local_map`` of ``fn``; ``grads`` (None entries: the input's own
        placements) gives the inputs' gradient placements."""
        if grads is not None:
            grads = tuple(i if g is None else g for g, i in zip(grads, ins))
        return local_map(fn, out_placements=out, in_placements=ins,
                         in_grad_placements=grads, device_mesh=self.mesh,
                         redistribute_inputs=True)

    def _all_reduce(self, t: torch.Tensor, op: str, axes) -> torch.Tensor:
        """``t`` reduced by ``op`` over ``axes`` (names; size-1 axes
        skipped), inside an island, with no gradient."""
        for a in axes:
            if self.r.size(a) > 1:
                t = funcol.all_reduce(t, op, (self.mesh,
                                              self.r.axis_names.index(a)))
        return funcol.wait_tensor(t) if isinstance(
            t, funcol.AsyncCollectiveTensor) else t

    def _model_index(self, axes=None) -> int:
        return self.r.shard_index(axes or (self.r.model_axis,))

    # ----- the layer code's operations -----

    def use(self, w: DTensor, dtype: torch.dtype) -> DTensor:
        """A parameter where it is used, in ``dtype``: gathered over the
        data axes (its FSDP dim; the serving layout has none), cast after
        the gather, or before it with ``param_gather_dtype`` bfloat16."""
        pl = list(w.placements)
        if not self.r.serving_layout:
            for m in self.ddims:
                pl[m] = Replicate()
        if self.r.param_gather_dtype == "bfloat16" and \
                w.dtype == torch.float32:
            w = w.to(torch.bfloat16)
        return w.redistribute(self.mesh, pl).to(dtype)

    def mm(self, x: DTensor, w: DTensor) -> DTensor:
        """x [..., K] @ w [K, N] (w in its use placements) on the local
        shards: x is first laid out to match w (K sharded where w's rows
        are, gathered where w's columns are); the output is sharded where
        either is and partial where K is."""
        last = x.ndim - 1
        xp = [Replicate() if pl.is_partial() else pl for pl in x.placements]
        out, gx, gw = [], [], []
        for m, wp in enumerate(w.placements):
            if wp == Shard(0):
                xp[m] = Shard(last)
                out.append(Partial())
                gx.append(Shard(last))
                gw.append(Shard(0))
            elif wp == Shard(1):
                xp[m] = Replicate()
                out.append(Shard(last))
                gx.append(Partial())
                gw.append(Shard(1))
            else:
                if xp[m] == Shard(last):
                    xp[m] = Replicate()
                out.append(xp[m])
                gx.append(xp[m])
                gw.append(Partial() if isinstance(xp[m], Shard)
                          else Replicate())
        x = self._redistribute(x, xp)
        return self._island(torch.matmul, out, (xp, list(w.placements)),
                            (gx, gw))(x, w)

    def shard_input(self, t: torch.Tensor, spec) -> DTensor:
        """A tensor every rank holds whole (or a DTensor) laid out by
        ``spec``."""
        if isinstance(t, DTensor):
            return self.put(t, spec)
        t = t.to(self.model.device)
        return self.r.from_local(
            t[self.r.local_slices(t.shape, spec)].contiguous(), spec, t.shape)

    def view(self, t: DTensor, i: int) -> DTensor:
        return view_of(t, i)

    def value(self, t: DTensor) -> torch.Tensor:
        """A 0-d result (the MoE aux) as a plain tensor, on every rank."""
        return t.full_tensor()

    def _vocab_shard(self):
        """The axes sharding the vocab (``tp(V)``), their mesh dims, and
        this rank's vocab rows [lo, lo + v_loc)."""
        r = self.r
        vax = r.tp(self.cfg.vocab_size)
        vaxes = () if vax is None else ((vax,) if isinstance(vax, str)
                                        else tuple(vax))
        v_loc = self.cfg.vocab_size // r.size(vaxes)
        return (vaxes, {r.axis_names.index(a) for a in vaxes}, v_loc,
                r.shard_index(vaxes) * v_loc)

    def embed(self, table: DTensor, tokens) -> DTensor:
        """The embedding island: each rank looks up the tokens whose rows
        it holds (the vocab over ``tp(V)``), zero elsewhere; the partial
        rows are summed over those axes."""
        r, cdt = self.r, self.model.compute_dtype
        b = tokens.shape[0]
        tok = self.shard_input(tokens.long(), (r.dp(b), None))
        table = self.use(table, table.dtype)
        _, vdims, v_loc, lo = self._vocab_shard()
        names = r.axis_names

        def body(tab, t):
            ok = (t >= lo) & (t < lo + v_loc)
            rows = tab[(t - lo).clamp(0, v_loc - 1)].to(cdt)
            return rows * ok[..., None].to(cdt)

        tp = list(tok.placements)
        out = [Partial() if m in vdims else tp[m] for m in range(len(names))]
        tab_g = [Shard(0) if m in vdims else
                 (Partial() if isinstance(tp[m], Shard) else Replicate())
                 for m in range(len(names))]
        return self._island(body, out, (list(table.placements), tp),
                            (tab_g, None))(table, tok)

    # ----- attention -----

    def ring(self, caches: dict, s: int, w: int):
        """Each call's ring rows are written by its shards in
        ``seq_attention``; this is what they need to know."""
        return s, w

    def seq_attention(self, q, k, v, positions, mrope_pos, cache, ring):
        """The reference's ``_seq_attn``: q, k, v sequence-sharded over
        ``model``, each shard's rows rotated at their positions, K and V
        gathered, the kernel on the shard's rows at ``q_offset``; with
        ``cache`` each shard writes its rows of the ring."""
        cfg, r = self.cfg, self.r
        b, s, _ = q.shape
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        seq = (r.dp(b), r.model_axis, None)
        q, k, v = (self.put(t, seq) for t in (q, k, v))
        q = q.reshape(b, s, nq, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        tp = r.model_size
        if s % tp:
            raise ValueError(f"sequence-sharded attention: S = {s} does not "
                             f"divide over {tp} model shards")
        s_loc = s // tp
        off = self._model_index() * s_loc
        seq4 = self._pl(r.seq_attn(b))
        full4 = self._pl((r.dp(b), None, None, None))
        grad4 = [Partial() if m == self.mdim else pl
                 for m, pl in enumerate(full4)]
        mp = None if mrope_pos is None else self.shard_input(
            mrope_pos, (r.dp(b), r.model_axis, None))
        mine = positions[off:off + s_loc]
        rope_of = self.model._rope

        def rope(ql, kl, mpl):
            return rope_of(ql, mine, mpl), rope_of(kl, mine, mpl)

        rope_in = (seq4, seq4, None if mp is None else
                   self._pl((r.dp(b), r.model_axis, None)))
        q, k = self._island(rope, (seq4, seq4), rope_in,
                            (seq4, seq4, None))(q, k, mp)
        kf, vf = (t.redistribute(self.mesh, full4) for t in (k, v))
        window = cfg.sliding_window

        def body(ql, kl, vl):
            return attention_op(ql, kl, vl, causal=True, window=window,
                                q_offset=off)

        out = self._island(body, seq4, (seq4, full4, full4),
                           (seq4, grad4, grad4))(q, kf, vf)
        if cache is not None:
            self._write_ring(cache, kf, vf, *ring, b)
        return out

    def _write_ring(self, cache: dict, kf: DTensor, vf: DTensor, s: int,
                    w: int, b: int):
        """Each shard of ``cache_axes`` builds its rows of the ring from the
        gathered k/v by the reference's slot rule: global slot g holds
        position p0 + (g - p0) mod w, p0 = max(0, s - w), or nothing (-1,
        zeros) past the prompt."""
        r = self.r
        cax = r.cache_axes
        w_loc = w // r.size(cax)
        my0 = self._model_index(cax) * w_loc
        dev = self.model.device
        full4 = self._pl((r.dp(b), None, None, None))
        kv_pl = self._pl((r.dp(b), cax, None, None))
        sp_pl = self._pl((cax,))

        def body(kl, vl, kc, vc, sp):
            g = my0 + torch.arange(w_loc, device=dev)
            p0 = max(0, s - w)
            src = p0 + torch.remainder(g - p0, w)
            valid = src < s
            safe = src.clamp(0, s - 1)
            mask = valid[None, :, None, None]
            kc.copy_(torch.where(mask, kl[:, safe], 0).to(kc.dtype))
            vc.copy_(torch.where(mask, vl[:, safe], 0).to(vc.dtype))
            sp.copy_(torch.where(valid, src, -1).to(sp.dtype))
            return kc

        self._island(body, kv_pl, (full4, full4, kv_pl, kv_pl, sp_pl))(
            kf, vf, cache["k"], cache["v"], cache["slot_pos"])

    def decode_attention(self, q, k, v, cache, pos, positions, mrope_pos):
        """One token against the sequence-sharded ring (the reference's
        ``_decode_attn``): the softmax's max and sums reduced over
        ``cache_axes``."""
        cfg, r = self.cfg, self.r
        b = q.shape[0]
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep = (r.dp(b), None, None)
        q, k, v = (self.put(t, rep) for t in (q, k, v))
        q, k, v = q.reshape(b, 1, nq, hd), k.reshape(b, 1, nkv, hd), \
            v.reshape(b, 1, nkv, hd)
        cax = r.cache_axes
        shards = r.size(cax)
        my = self._model_index(cax)
        reduce = (None if shards == 1 else
                  lambda t, op: self._all_reduce(t, op, cax))

        def body(ql, kl, vl, kc, vc, sp):
            # every row of M-RoPE's positions is pos: any of them will do
            mp = None if mrope_pos is None else mrope_pos[:ql.shape[0]]
            return self.model._decode_attend(
                ql, kl, vl, {"k": kc, "v": vc, "slot_pos": sp}, pos,
                positions, mp, shard=my, shards=shards, reduce=reduce)

        rep4 = self._pl((r.dp(b), None, None, None))
        kv_pl = self._pl((r.dp(b), cax, None, None))
        return self._island(body, rep4, (rep4, rep4, rep4, kv_pl, kv_pl,
                                         self._pl((cax,))))(
            q, k, v, cache["k"], cache["v"], cache["slot_pos"])

    # ----- MoE -----

    def moe(self, p: dict, m: DTensor):
        """The MoE island (the reference's ``make_sharded_moe``): tokens of
        the rank's data shard, replicated over ``model``; ``"ep"`` when the
        experts divide the model axis, else ``"tp"``."""
        cfg, r = self.cfg, self.r
        moe = cfg.moe
        b = m.shape[0]
        names = r.axis_names
        nd = len(names)
        e = moe.num_experts
        use_ep = r.moe_sharding == "ep" and e % r.model_size == 0
        if use_ep:
            sum_axes = (r.model_axis,)
            e_loc = e // r.model_size
            offset = self._model_index() * e_loc
        else:
            fax = r.tp(cfg.d_ff)
            sum_axes = (fax,) if isinstance(fax, str) else (
                tuple(fax) if fax else (r.model_axis,))
            e_loc, offset = None, 0
        sum_dims = {names.index(a) for a in sum_axes}
        dt = m.dtype
        weights = [self.use(p[n], p[n].dtype) for n in
                   ("router", "w_gate", "w_up", "w_down")]
        xin = self._pl((r.dp(b), None, None))
        out_y = [Partial() if i in sum_dims else xin[i] for i in range(nd)]
        grad_x = [Partial() if i in sum_dims else xin[i] for i in range(nd)]
        # a replicated weight's gradient is a partial sum: over the model
        # ranks' slices of the work, and over the data shards' tokens
        grad_w = [[Partial() if isinstance(wp, Replicate) and (
                       i == self.mdim or i in sum_dims or r.dp(b) is not None)
                   else wp for i, wp in enumerate(w.placements)]
                  for w in weights]
        scale = 1.0 / (r.data_size * r.model_size)

        def body(x, rw, wg, wu, wd):
            y, aux = moe_lib.moe_block(
                x, rw, wg.to(dt), wu.to(dt), wd.to(dt), moe=moe,
                expert_offset=offset, local_experts=e_loc)
            # every rank's share of the mean over the data shards
            return y, aux * scale

        return self._island(
            body, (out_y, [Partial()] * nd),
            (xin, *[list(w.placements) for w in weights]),
            (grad_x, *grad_w))(m, *weights)

    # ----- Mamba2 -----

    def ssm(self, p, x, Bm, Cm, dtr, cache, mode):
        """``ssm_mix`` in an island on the rank's heads (``tp(heads)``), B
        and C replicated."""
        cfg, r, s_cfg = self.cfg, self.r, self.cfg.ssm
        b = x.shape[0]
        di = s_cfg.expand * cfg.d_model
        nh = di // s_cfg.head_dim
        if (r.tp(di) is None) != (r.tp(nh) is None):
            raise ValueError("mamba: d_inner and the heads must shard alike")
        split = r.tp(nh) is not None
        ws = [self.use(p[name], torch.float32) for name in _SSM_WEIGHTS]
        heads = (r.dp(b), None, r.tp(di) if split else None)
        rep = (r.dp(b), None, None)
        x, dtr = (self.put(t, heads) for t in (x, dtr))
        Bm, Cm = (self.put(t, rep) for t in (Bm, Cm))
        act_in = [self._pl(heads), self._pl(rep), self._pl(rep),
                  self._pl(heads)]
        w_in = [list(w.placements) for w in ws]
        # gradients: B and C (and their conv weights), replicated over
        # model, take partial sums from the rank's heads; every weight a
        # partial sum over the data shards' rows
        bc_grad = [Partial() if split and m == self.mdim else pl_
                   for m, pl_ in enumerate(act_in[1])]
        act_grad = [act_in[0], bc_grad, bc_grad, act_in[3]]
        w_grad = []
        for pl in w_in:
            gp = []
            for m, p_ in enumerate(pl):
                if isinstance(p_, Shard):
                    gp.append(p_)
                elif m == self.mdim:
                    gp.append(Partial() if split else Replicate())
                else:
                    gp.append(Partial() if r.dp(b) is not None
                              else Replicate())
            w_grad.append(gp)
        names = ("ssm", "conv_x", "conv_B", "conv_C") if cache else ()
        cache_pl = self._cache_placements(b)

        def body(xl, Bl, Cl, dl, *rest):
            w = dict(zip(_SSM_WEIGHTS, rest))
            caches = dict(zip(names, rest[len(_SSM_WEIGHTS):])) or None
            return ssm_mix(s_cfg, r, xl, Bl, Cl, dl, w, caches, mode)

        return self._island(
            body, self._pl(heads),
            (*act_in, *w_in, *(cache_pl[k] for k in names)),
            (*act_grad, *w_grad, *(None,) * len(names)))(
            x, Bm, Cm, dtr, *ws, *(cache[k] for k in names))

    # ----- the loss -----

    def unembed_cross_entropy(self, h: DTensor, table: DTensor,
                              labels) -> torch.Tensor:
        """The training loss on the mesh, as the one-device path made it
        before its vocab-chunked operator: the fp32 upcasts' product, the
        logits vocab-sharded (``act_logits``), then ``cross_entropy``."""
        logits = self.put(self.mm(h.float(), table.float()),
                          self.r.act_logits(h.shape[0], self.cfg.vocab_size))
        return self.cross_entropy(logits, labels)

    def cross_entropy(self, logits: DTensor, labels) -> torch.Tensor:
        """Mean over positions of logsumexp(logits) - logits[label] on the
        vocab-sharded fp32 logits: each rank scores its vocab rows; the row
        max is an all-reduce MAX (no gradient: the result does not depend
        on it), sum(exp) and the label's logit partial sums."""
        r = self.r
        b = logits.shape[0]
        lab = self.shard_input(labels.long(), (r.dp(b), None))
        vaxes, vdims, v_loc, lo = self._vocab_shard()
        names = r.axis_names
        lp = list(lab.placements)

        def body(lg, lb):
            m = self._all_reduce(lg.detach().amax(dim=-1), "max", vaxes)
            sumexp = torch.exp(lg - m[..., None]).sum(dim=-1)
            ok = (lb >= lo) & (lb < lo + v_loc)
            picked = lg.gather(-1, (lb - lo).clamp(0, v_loc - 1)[..., None])
            return m, sumexp, picked[..., 0] * ok

        part = [Partial() if i in vdims else lp[i] for i in range(len(names))]
        m, sumexp, picked = self._island(
            body, (lp, part, part), (list(logits.placements), lp),
            (list(logits.placements), None))(logits, lab)
        sumexp, picked = (t.redistribute(self.mesh, lp)
                          for t in (sumexp, picked))
        ce = (torch.log(sumexp) + m - picked).mean()
        return ce.full_tensor()

    # ----- params and caches -----

    def init(self, dtype: torch.dtype, draw) -> dict:
        """``Model.init`` on the mesh: each leaf drawn part by part (on the
        generator's device) in the one-device order, the rank keeping its
        slice."""
        r, dev = self.r, self.model.device

        def make(leaf):
            dt = torch.float32 if leaf.fp32 else dtype
            mine = r.local_slices(leaf.shape, leaf.spec)
            local = torch.empty(tuple(s.stop - s.start for s in mine),
                                dtype=dt, device=dev)
            for index, shape in init_parts(leaf.shape):
                part = draw(leaf.init, shape)
                hit = _intersect(index, mine)
                if hit is not None:
                    local[hit[1]].copy_(part[hit[0]])
            return r.from_local(local, leaf.spec, leaf.shape)

        return map_schema(make, self.model.param_schema())

    def cache_specs(self, batch: int) -> dict:
        """The reference's ``cache_specs``, per entry of the port's flat
        cache dict (a stacked leading dim, unsharded)."""
        r = self.r
        dp, tp, cax = r.dp(batch), r.model_axis, r.cache_axes
        return {"ssm": (None, dp, tp, None, None),
                "conv_x": (None, dp, None, tp),
                "conv_B": (None, dp, None, None),
                "conv_C": (None, dp, None, None),
                "k": (None, dp, cax, None, None),
                "v": (None, dp, cax, None, None),
                "slot_pos": (None, cax)}

    def _cache_placements(self, batch: int) -> dict:
        """Placements of one layer's (or call's) view of each cache."""
        return {k: self._pl(spec[1:])
                for k, spec in self.cache_specs(batch).items()}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        specs = self.cache_specs(batch)
        out = {}
        for name, shape in self.model.cache_shapes(batch, cache_len).items():
            spec = specs[name]
            local = tuple(sl.stop - sl.start for sl in
                          self.r.local_slices(shape, spec))
            dev = self.model.device
            if name == "slot_pos":
                t = torch.full(local, -1, dtype=torch.int32, device=dev)
            else:
                t = torch.zeros(local, device=dev, dtype=torch.float32
                                if name == "ssm" else self.model.compute_dtype)
            out[name] = self.r.from_local(t, spec, shape)
        return out
