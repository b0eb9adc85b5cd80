"""Mixture-of-experts block: the counterpart of the JAX package's
``models/moe.py``. ``moe_block`` is its ``moe_block_local`` over the
tokens and expert weights one rank holds; on one device all of them. On a
mesh the model runs it inside an island (``models/sharded.py``) with the
reference's collectives: under ``"tp"`` each rank holds every expert's
slice of the hidden dim, under ``"ep"`` E / tp whole experts
(``expert_offset``, ``local_experts``); the partial outputs are summed
over the model axis (all of them in the serving layout) and the aux
averaged over the data axes. Capacity counts the rank's tokens, as the
reference's counts its data shard's.

Dispatch is the reference's sort-based dropping scheme: the T·k
assignments of the call's T tokens are stably sorted by expert, each
expert keeps its first ``capacity_for(T)`` in that order and drops the
rest, the kept rows are copied into an [E, C, D] buffer, the experts run
as three batched products, and each token sums its kept experts' rows
weighted by its renormalised router gates. Capacity counts every token of
the call, padding included, as the reference's does.

Rows move only by gathers, forward and backward (``_Rows``), so no step
adds into a row in an order the device chooses, and no gradient goes
through an indexing backward (a sort and an accumulation: 3.2 ms a call
at moonshot-v1-16b-a3b's training shape on the H100):
  * the dispatch gathers each buffer slot's token row; its gradient
    gathers each token's k slots back and adds them in a fixed order;
  * the combine gathers each token's k expert rows in the stable sort's
    order (ascending expert) and adds them one after the other, in the
    experts' dtype, as the reference's scatter-add sums them; its
    gradient gathers each slot's token row back. There is no
    ``index_add_`` or atomic scatter-add.
Dropped assignments and empty slots read a zero row past the source.

Plain functions on tensors; the spans ``moe.router``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` (``repro_torch.core.profiler.span``)
name the block's parts in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.profiler import span


def router_topk(x32: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-k routing with renormalised gates; x32 [T, D] fp32. The router
    runs in fp32 whatever the weights' dtype. Ties go to the lower expert
    index, as ``jax.lax.top_k``'s do: a stable descending sort keeps equal
    probabilities in index order. Returns (probs [T, E], gate [T, k],
    idx [T, k])."""
    logits = x32 @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def load_balance_aux(probs: torch.Tensor, idx: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss over the first choice: E · Σ f_e p_e,
    f the share of tokens whose first choice is e (no gradient), p the
    mean router probability (with one)."""
    f = F.one_hot(idx[:, 0], num_experts).float().mean(dim=0)
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def _dispatch_indices(idx: torch.Tensor, tokens: int, num_experts: int,
                      capacity: int):
    """Sort-based dispatch bookkeeping, all [T·k], in the stable sort's
    order: (order, the flat assignment at each position; se, its expert;
    st, its token; pos, its place in its expert's group; keep, pos <
    capacity)."""
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k
    group_start = torch.searchsorted(
        se, torch.arange(num_experts, device=idx.device, dtype=se.dtype),
        side="left")
    pos = torch.arange(tokens * k, device=idx.device) - group_start[se]
    keep = pos < capacity
    return order, se, st, pos, keep


def _expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU in the activations' dtype: xe [E, C, D]
    -> [E, C, D]."""
    dt = xe.dtype
    g = F.silu(torch.bmm(xe, w_gate.to(dt)))
    u = torch.bmm(xe, w_up.to(dt))
    return torch.bmm(g * u, w_down.to(dt))


class _Rows(torch.autograd.Function):
    """``src`` [N, D] with a zero row appended, gathered by ``index`` (N:
    the zero row). ``inverse`` [N, m] lists, for each row of ``src``, the
    output rows it went to (len(index): none); the gradient gathers them
    and adds them in that order."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([src, src.new_zeros(1, src.shape[1])])[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        rows = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])[inverse]
        out = rows[:, 0]
        for j in range(1, rows.shape[1]):
            out = out + rows[:, j]
        return out, None, None


def capacity_for(tokens: int, moe: MoEConfig) -> int:
    return max(1, math.ceil(tokens * moe.experts_per_token
                            / moe.num_experts * moe.capacity_factor))


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, *, moe: MoEConfig,
              expert_offset: int = 0, local_experts: int | None = None):
    """The block over x [..., D] (every leading position one token of the
    call): router_w [D, E], w_gate / w_up [E, D, F], w_down [E, F, D]
    (F may be a slice of the hidden dim, whose output is then a partial
    sum). ``local_experts``: the weights are experts [expert_offset,
    expert_offset + local_experts) only, and assignments to the others
    contribute nothing here (the reference's ``"ep"`` block on one rank).
    Returns (y, x's shape and dtype; the fp32 load-balance aux)."""
    shape = x.shape
    d = shape[-1]
    x = x.reshape(-1, d)
    t = x.shape[0]
    e, k = moe.num_experts, moe.experts_per_token
    n, cap = t * k, capacity_for(t, moe)
    e_loc = e if local_experts is None else local_experts
    with span("moe.router"):
        probs, gate, idx = router_topk(x.float(), router_w, k)
        aux = load_balance_aux(probs, idx, e)
    with span("moe.dispatch"):
        order, se, st, pos, keep = _dispatch_indices(idx, t, e, cap)
        if local_experts is not None:
            keep = keep & (se >= expert_offset) & (
                se < expert_offset + local_experts)
        slots = e_loc * cap
        # each token's k places in the sorted order, ascending: its
        # experts in the order the reference's scatter-add meets them;
        # and, the other way, the (token, place) of each sorted position
        where = torch.argsort(order).view(t, k).sort(dim=-1).values
        flat = torch.argsort(where.view(-1))
        # each sorted position's buffer slot (slots: dropped), the slots of
        # each token's places, and each slot's token and (token, place)
        # (t and n: empty), written through indices that are all distinct
        slot = torch.where(keep, (se - expert_offset) * cap + pos, slots)
        token_slots = slot[where]
        dest = torch.where(keep, slot,
                           slots + torch.arange(n, device=x.device))
        slot_token = torch.full((slots + n,), t, device=x.device,
                                dtype=st.dtype)
        slot_token[dest] = st
        slot_place = torch.full_like(slot_token, n)
        slot_place[dest] = flat
        xe = _Rows.apply(x, slot_token[:slots], token_slots).view(e_loc, cap,
                                                                  d)
    with span("moe.experts"):
        ye = _expert_ffn(xe, w_gate, w_up, w_down).view(slots, d)
    with span("moe.combine"):
        rows = _Rows.apply(ye, token_slots.view(-1),
                           slot_place[:slots, None]).view(t, k, d)
        sg = gate.gather(1, order[where] % k).to(ye.dtype)
        rows = sg[..., None] * rows
        y = rows[:, 0]
        for j in range(1, k):
            y = y + rows[:, j]
    return y.to(x.dtype).view(shape), aux
