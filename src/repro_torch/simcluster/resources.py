"""Deterministic fluid (processor-sharing) simulation of shared resources.

A ``FluidResource`` is a contended source (container registry, SCM package
host, HDFS cluster) with aggregate capacity, a per-client rate cap, and the
rate-limiting behaviour observed in §3.4: beyond ``throttle_after``
concurrent clients the source throttles to ``capacity / throttle_factor``.

``simulate_stage`` runs max-min fair sharing exactly: on every arrival or
completion the per-transfer rates are recomputed; between events transfers
progress linearly.  This reproduces the emergent contention shapes (long
tails, scale-dependent slowdown) without wall-clock sleeps.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FluidResource:
    name: str
    capacity: float                  # aggregate bytes/s
    per_client: float                # per-transfer cap (NIC / stream limit)
    throttle_after: int = 1 << 30    # concurrent clients before rate limit
    throttle_factor: float = 1.0     # capacity divisor once throttled
    # resources sharing a ``share_group`` draw from ONE capacity pool
    # (declare them with EQUAL capacity — the group uses the first seen)
    # while each transfer keeps its own resource's per_client cap.  This
    # is how the overlapped startup sim models two access paths (env
    # archive windows, striped ckpt reads) hitting the SAME DFS.
    share_group: Optional[str] = None


@dataclass
class Transfer:
    node: str
    resource: FluidResource
    nbytes: float
    start: float = 0.0               # local work before the transfer begins
    # p2p scaling: effective capacity grows by this many bytes/s per
    # *completed* peer (peers that already hold the data serve others)
    p2p_bonus_per_done: float = 0.0


def wan_links(num_regions: int, *, capacity: float, per_link: float,
              asymmetry: float = 1.0,
              share_group: str = "wan") -> dict[int, FluidResource]:
    """Per-region WAN ingress links for a federated (multi-region) swarm.

    Region 0 hosts the registry/seed; each other region r pulls its seed
    copy over ONE logical WAN link.  All links draw from a single shared
    backbone ``capacity`` pool (``share_group``), while each region's
    per-transfer cap models its own link rate: ``per_link`` for region 1,
    degraded by ``asymmetry`` per additional region hop (region r gets
    ``per_link * asymmetry**(r-1)``) — the bandwidth asymmetry of real
    WAN topologies, where far regions ride thinner or more contended
    pipes.  Returns {region_index: FluidResource} for regions 1..n-1.
    """
    if num_regions < 1:
        raise ValueError(f"num_regions must be >= 1, got {num_regions}")
    if not 0.0 < asymmetry <= 1.0:
        raise ValueError(f"asymmetry must be in (0, 1], got {asymmetry}")
    return {
        r: FluidResource(f"wan_r{r}", capacity,
                         per_link * asymmetry ** (r - 1),
                         share_group=share_group)
        for r in range(1, num_regions)}


def dissemination_waves(n: int, fanout: int) -> list[int]:
    """Wave index (1-based) for each of ``n`` receivers fed from ONE
    initial holder through a bounded-degree tree: every completed receiver
    becomes a holder, and each holder serves at most ``fanout`` children
    per wave — so wave k can admit ``holders_k * fanout`` new receivers
    and the tree completes in O(log n) waves.  This is the fluid-model
    twin of ``repro_torch.blockstore.swarm``'s serve-slot bound."""
    waves: list[int] = []
    holders, wave, remaining = 1, 1, n
    while remaining > 0:
        take = min(holders * max(fanout, 1), remaining)
        waves.extend([wave] * take)
        holders += take
        remaining -= take
        wave += 1
    return waves


def simulate_overlapped(transfers: list[Transfer]
                        ) -> dict[str, dict[str, float]]:
    """One fluid simulation of MANY overlapping startup tasks.

    Transfers carry ``"node|task"`` composite names, so concurrent tasks
    (image fetch, env-cache restore, checkpoint params wave) contend for
    their shared ``FluidResource``s inside a SINGLE event simulation —
    the fluid-model twin of the pipelined startup DAG, where only real
    data dependencies (not stage barriers) order the I/O.  Returns
    ``{node: {task: completion_s}}``.
    """
    finish = simulate_stage(transfers)
    out: dict[str, dict[str, float]] = {}
    for key, t in finish.items():
        node, _, task = key.partition("|")
        out.setdefault(node, {})[task] = t
    return out


def _pool_key(res: FluidResource) -> str:
    return res.share_group or res.name


def _rates(active: list[Transfer], done_count: dict) -> dict[int, float]:
    """Max-min fair allocation per capacity pool (equal split, per-client
    cap); resources with a common ``share_group`` form one pool."""
    by_res: dict[str, list[Transfer]] = {}
    for t in active:
        by_res.setdefault(_pool_key(t.resource), []).append(t)
    rates: dict[int, float] = {}
    for rname, ts in by_res.items():
        res = ts[0].resource
        cap = res.capacity
        avg_bonus = sum(t.p2p_bonus_per_done for t in ts) / max(len(ts), 1)
        cap += avg_bonus * done_count.get(rname, 0)
        n = len(ts)
        if n > res.throttle_after:
            cap /= res.throttle_factor
        share = cap / n
        for t in ts:
            rates[id(t)] = min(t.resource.per_client, share)
    return rates


def simulate_stage(transfers: list[Transfer],
                   extra_work: Optional[dict[str, float]] = None
                   ) -> dict[str, float]:
    """Simulate one startup stage.

    Every transfer starts at its ``start`` offset (local pre-work); a node's
    stage duration = completion of its last transfer + its ``extra_work``.
    Returns {node: stage_seconds}.  Nodes with no transfers get just their
    extra_work.
    """
    extra_work = extra_work or {}
    t_now = 0.0
    remaining = {id(t): float(t.nbytes) for t in transfers}
    pending = sorted(transfers, key=lambda t: t.start)
    active: list[Transfer] = []
    finish: dict[str, float] = {}
    done_count: dict[str, int] = {}

    def node_done(node, t_end):
        finish[node] = max(finish.get(node, 0.0), t_end)

    i = 0
    while pending and pending[0].start <= t_now:
        active.append(pending.pop(0))

    while active or pending:
        if not active:
            t_now = pending[0].start
            while pending and pending[0].start <= t_now:
                active.append(pending.pop(0))
            continue
        rates = _rates(active, done_count)
        # time to next completion
        dt_done = min((remaining[id(t)] / max(rates[id(t)], 1e-12)
                       for t in active), default=float("inf"))
        dt_arr = (pending[0].start - t_now) if pending else float("inf")
        dt = min(dt_done, dt_arr)
        for t in active:
            remaining[id(t)] -= rates[id(t)] * dt
        t_now += dt
        still = []
        for t in active:
            if remaining[id(t)] <= 1e-9:
                node_done(t.node, t_now)
                key = _pool_key(t.resource)
                done_count[key] = done_count.get(key, 0) + 1
            else:
                still.append(t)
        active = still
        while pending and pending[0].start <= t_now + 1e-12:
            active.append(pending.pop(0))

    out: dict[str, float] = {}
    nodes = {t.node for t in transfers} | set(extra_work)
    for node in nodes:
        base = finish.get(node, 0.0)
        # transfers with pure local work only (start offset, zero bytes)
        out[node] = base + extra_work.get(node, 0.0)
    return out
