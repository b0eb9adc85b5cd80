"""Cluster-trace generator for the §3 characterization figures.

Produces a synthetic one-week trace with the same statistical structure the
paper reports for 28,000+ jobs / 700k+ requested GPUs: a heavy-tailed job
size distribution, startup counts that grow with job size (debug/restart
cycles, Fig. 4), and per-startup stage durations from the workload model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.stages import Stage
from repro_torch.simcluster.workload import ClusterParams, StartupWorkload


@dataclass
class JobRecord:
    job_id: str
    gpus: int
    servers: int
    startups: int
    queue_s: float
    alloc_s: float
    stage_max_s: dict          # per stage: job-level (max over nodes)
    stage_median_s: dict
    node_level_s: float        # median node-level total
    job_level_s: float
    train_hours: float


def generate_cluster_trace(n_jobs: int = 2000, *, seed: int = 0,
                           bootseer: bool = False,
                           params: ClusterParams | None = None
                           ) -> list[JobRecord]:
    rng = np.random.default_rng(seed)
    params = params or ClusterParams()
    out: list[JobRecord] = []

    # job size: log-uniform-ish mixture, most jobs small, few huge (§3)
    raw = rng.lognormal(mean=2.2, sigma=1.6, size=n_jobs)
    gpus = np.clip((raw / 4).astype(int) * 8 + 8, 8, 16384)

    for j in range(n_jobs):
        g = int(gpus[j])
        servers = max(1, g // 8)
        # startups grow with scale (Fig. 4): 1 for small, 2-8 large, tail 20+
        lam = 0.5 * np.log2(max(servers, 2))
        startups = 1 + rng.poisson(lam)
        if rng.random() < 0.008 * np.log2(max(servers, 2)):
            startups += rng.integers(8, 20)

        # scheduler phase (no GPUs consumed): queue ~100 s typical, long tail
        queue_s = float(rng.lognormal(np.log(100), 1.0))
        alloc_s = float(rng.uniform(1, 5))

        # one representative startup simulated at reduced node count for
        # tractability; durations scale like the fluid model predicts
        sim_servers = int(min(servers, 256))
        w = StartupWorkload(params=params, bootseer=bootseer,
                            seed=seed * 131 + j)
        r = w.run(sim_servers, run_idx=1)
        stage_max = {s: max(v.values()) for s, v in r["stages"].items()}
        stage_med = {s: float(np.median(list(v.values())))
                     for s, v in r["stages"].items()}
        node_med = float(np.median(list(r["node_level"].values())))

        # jobs train for hours-to-days between startups; the cluster-level
        # waste fraction (Fig. 1) lands at a few percent
        train_hours = float(rng.lognormal(np.log(2.4), 1.1)) * startups
        out.append(JobRecord(
            job_id=f"job{j:06d}", gpus=g, servers=servers,
            startups=int(startups), queue_s=queue_s, alloc_s=alloc_s,
            stage_max_s=stage_max, stage_median_s=stage_med,
            node_level_s=node_med + queue_s + alloc_s,
            job_level_s=r["job_level"] + queue_s + alloc_s,
            train_hours=train_hours))
    return out


def gpu_time_waste_fraction(trace: list[JobRecord]) -> dict:
    """Fig. 1: fraction of GPU-server-hours consumed by startup overhead."""
    startup_h, train_h = 0.0, 0.0
    for r in trace:
        gpu_stage_s = sum(r.stage_max_s.values())
        startup_h += r.servers * r.startups * gpu_stage_s / 3600
        train_h += r.servers * r.train_hours
    total = startup_h + train_h
    return {"startup_hours": startup_h, "train_hours": train_h,
            "startup_fraction": startup_h / total if total else 0.0}
