"""The port's startup twin (``repro_torch.simcluster``) against the JAX
package's (``repro.simcluster``): the same inputs give results equal with
``==`` (the same defaults, seeds and arithmetic, so no tolerance), and the
reference's own claims about the twin hold on the port.

The claims of ``tests/test_simcluster.py`` run as they are written, its
imports pointed at the port (``_port_of``); the twin's cases of the other
reference test files, which import much else, are restated below with
the port's imports.
"""

import dataclasses
import statistics
from pathlib import Path

import pytest

pytest.importorskip(
    "hypothesis", reason="property tests need the optional hypothesis dep")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.simcluster import resources as jresources  # noqa: E402
from repro.simcluster import trace as jtrace  # noqa: E402
from repro.simcluster import workload as jworkload  # noqa: E402
from repro_torch.core.stages import Stage  # noqa: E402
from repro_torch.simcluster import resources, trace, workload  # noqa: E402
from repro_torch.simcluster.workload import (ClusterParams,  # noqa: E402
                                             StartupWorkload)

TESTS = Path(__file__).resolve().parent
SET = dict(deadline=None, max_examples=25,
           suppress_health_check=[HealthCheck.function_scoped_fixture])


def _port_of(name: str) -> dict:
    """The namespace of the reference's test module ``name`` with its
    twin imports pointed at the port; it may import nothing else of the
    JAX package."""
    path = TESTS / name
    src = path.read_text()
    for mod in ("repro.simcluster", "repro.core.stages"):
        src = src.replace(f"from {mod}", f"from {mod.replace('repro', 'repro_torch', 1)}")
    assert "repro." not in src.replace("repro_torch.", ""), name
    ns = {"__name__": f"port_of_{path.stem}"}
    exec(compile(src, str(path), "exec"), ns)
    return ns


_REFERENCE = _port_of("test_simcluster.py")
TestFluidSim = _REFERENCE["TestFluidSim"]
TestWorkload = _REFERENCE["TestWorkload"]
TestTrace = _REFERENCE["TestTrace"]
TestWanFederation = _REFERENCE["TestWanFederation"]


def test_the_reference_claims_are_the_ports():
    """Every test class of the reference's file runs here, on the port."""
    assert {k for k in _REFERENCE if k.startswith("Test")} == {
        "TestFluidSim", "TestWorkload", "TestTrace", "TestWanFederation"}
    assert StartupWorkload.__module__ == "repro_torch.simcluster.workload"
    assert _REFERENCE["StartupWorkload"] is StartupWorkload


# ---------------------------------------------------------------------------
# the twin against the reference, with ==
# ---------------------------------------------------------------------------

def _outcome(module, params: dict, kwargs: dict, nodes: int, run_idx: int):
    """The run's result dict, or the error it raised (type name, text)."""
    p = module.ClusterParams(**params)
    try:
        return module.StartupWorkload(params=p, **kwargs).run(nodes, run_idx)
    except ValueError as e:
        return ("ValueError", str(e))


GRID = [(f"{'bootseer' if b else 'baseline'}-{'pipe' if pl else 'seq'}"
         f"-run{r}-n{n}", {}, {"bootseer": b, "pipeline": pl, "seed": 1},
         n, r)
        for b in (True, False) for pl in (True, False) for r in (0, 1)
        for n in (2, 16, 128)]
KNOBS = [
    ("regions3", {"num_regions": 3}, {"bootseer": True, "seed": 2}, 24, 1),
    ("erasure-lost1", {"ckpt_placement": "erasure"},
     {"bootseer": True, "seed": 3, "lost_stripes": 1}, 16, 1),
    ("erasure-lost3", {"ckpt_placement": "erasure"},
     {"bootseer": True, "seed": 3, "lost_stripes": 3}, 16, 1),
    ("striped-lost1", {}, {"bootseer": True, "seed": 3, "lost_stripes": 1},
     16, 1),
    ("restore-ahead-delta", {},
     {"bootseer": True, "seed": 3, "restore_ahead_coverage": 0.5,
      "delta_chain_len": 3}, 32, 1),
    ("autotune-run0", {}, {"bootseer": True, "autotune": True}, 16, 0),
    ("autotune-run1", {}, {"bootseer": True, "autotune": True}, 16, 1),
    ("autotune-baseline", {}, {"bootseer": False, "autotune": True}, 16, 1),
    ("rdma-env-cache", {}, {"bootseer": True, "rdma_env_cache": True,
                            "seed": 1}, 64, 1),
]


@pytest.mark.parametrize("params,kwargs,nodes,run_idx",
                         [c[1:] for c in GRID + KNOBS],
                         ids=[c[0] for c in GRID + KNOBS])
def test_run_equals_the_reference(params, kwargs, nodes, run_idx):
    ours = _outcome(workload, params, kwargs, nodes, run_idx)
    ref = _outcome(jworkload, params, kwargs, nodes, run_idx)
    assert ours == ref


def test_infeasible_restores_raise_as_the_reference():
    """The striped placement cannot lose a stripe; erasure cannot lose
    more than its parity: both packages refuse with the same words."""
    for params, lost, words in (({}, 1, "StripeMissingError"),
                                ({"ckpt_placement": "erasure"}, 3,
                                 "unrecoverable")):
        out = _outcome(workload, params, {"bootseer": True, "seed": 3,
                                          "lost_stripes": lost}, 16, 1)
        assert out[0] == "ValueError" and words in out[1]


def test_default_params_equal_the_reference():
    assert dataclasses.asdict(ClusterParams()) == dataclasses.asdict(
        jworkload.ClusterParams())
    ours = {f.name: f.default for f in dataclasses.fields(StartupWorkload)
            if f.name != "params"}
    assert ours == {f.name: f.default
                    for f in dataclasses.fields(jworkload.StartupWorkload)
                    if f.name != "params"}


@pytest.mark.parametrize("n_jobs,seed,bootseer", [(60, 0, False),
                                                  (60, 1, True)])
def test_trace_equals_the_reference(n_jobs, seed, bootseer):
    ours = trace.generate_cluster_trace(n_jobs, seed=seed, bootseer=bootseer)
    ref = jtrace.generate_cluster_trace(n_jobs, seed=seed, bootseer=bootseer)
    assert [dataclasses.asdict(r) for r in ours] == \
        [dataclasses.asdict(r) for r in ref]
    assert trace.gpu_time_waste_fraction(ours) == \
        jtrace.gpu_time_waste_fraction(ref)


def test_waves_and_links_equal_the_reference():
    for n in range(0, 70, 7):
        for fanout in (0, 1, 4):
            assert resources.dissemination_waves(n, fanout) == \
                jresources.dissemination_waves(n, fanout)
    ours = resources.wan_links(4, capacity=10.0, per_link=4.0,
                               asymmetry=0.5)
    ref = jresources.wan_links(4, capacity=10.0, per_link=4.0,
                               asymmetry=0.5)
    assert {r: dataclasses.asdict(v) for r, v in ours.items()} == \
        {r: dataclasses.asdict(v) for r, v in ref.items()}


# ---------------------------------------------------------------------------
# the fluid simulation on random transfers (as tests/test_property.py
# draws them), against the reference's
# ---------------------------------------------------------------------------

def _transfers(module, nbytes, cap, per, starts, bonus, shared):
    """Transfers on two resources (one pool when ``shared``), with local
    work before each and a p2p bonus, as ``module``'s classes."""
    group = "pool" if shared else None
    res = [module.FluidResource("a", cap, per, share_group=group),
           module.FluidResource("b", cap, per / 2, throttle_after=3,
                                throttle_factor=2.0, share_group=group)]
    return [module.Transfer(f"n{i % 5}|t{i}", res[i % 2], b,
                            start=starts[i % len(starts)],
                            p2p_bonus_per_done=bonus)
            for i, b in enumerate(nbytes)]


@given(nbytes=st.lists(st.floats(1.0, 1e6), min_size=1, max_size=12),
       cap=st.floats(10.0, 1e5), per=st.floats(10.0, 1e5),
       starts=st.lists(st.floats(0.0, 50.0), min_size=1, max_size=4),
       bonus=st.sampled_from([0.0, 5.0]), shared=st.booleans())
@settings(**SET)
def test_fluid_sims_equal_the_reference(nbytes, cap, per, starts, bonus,
                                        shared):
    args = (nbytes, cap, per, starts, bonus, shared)
    assert resources.simulate_stage(_transfers(resources, *args)) == \
        jresources.simulate_stage(_transfers(jresources, *args))
    assert resources.simulate_overlapped(_transfers(resources, *args)) == \
        jresources.simulate_overlapped(_transfers(jresources, *args))
    extra = {"n0|t0": starts[0], "lonely": cap / per}
    assert resources.simulate_stage(_transfers(resources, *args), extra) == \
        jresources.simulate_stage(_transfers(jresources, *args), extra)


# ---------------------------------------------------------------------------
# the twin's cases of test_extensions.py, test_fabric.py, test_ckpt_delta.py
# and test_tune.py, on the port
# ---------------------------------------------------------------------------

class TestRdmaEnvCache:
    def test_rdma_beats_hdfs_restore(self):
        """§7 future work: env cache over an RDMA memory pool."""
        base = StartupWorkload(bootseer=True, seed=1).run(64)
        rdma = StartupWorkload(bootseer=True, rdma_env_cache=True,
                               seed=1).run(64)
        b = max(base["stages"][Stage.ENV_SETUP.value].values())
        r = max(rdma["stages"][Stage.ENV_SETUP.value].values())
        assert r < b
        assert rdma["job_level"] < base["job_level"]

    def test_rdma_scales_with_peers(self):
        small = StartupWorkload(bootseer=True, rdma_env_cache=True,
                                seed=2).run(4)
        big = StartupWorkload(bootseer=True, rdma_env_cache=True,
                              seed=2).run(256)
        s = statistics.median(small["stages"][Stage.ENV_SETUP.value]
                              .values())
        b = statistics.median(big["stages"][Stage.ENV_SETUP.value].values())
        assert b < s * 3


class TestSimFabric:
    def test_degraded_erasure_amplifies_model_init(self):
        params = ClusterParams(ckpt_placement="erasure")
        healthy = StartupWorkload(bootseer=True, seed=3,
                                  params=params).run(8)
        degraded = StartupWorkload(bootseer=True, seed=3, params=params,
                                   lost_stripes=1).run(8)
        assert healthy["read_amplification"] == 1.0
        assert 1.0 < degraded["read_amplification"] <= 2.0
        h = max(healthy["stages"]["model_init"].values())
        d = max(degraded["stages"]["model_init"].values())
        assert h < d <= 2.5 * h

    def test_striped_cannot_survive_lost_stripe(self):
        with pytest.raises(ValueError, match="StripeMissingError"):
            StartupWorkload(bootseer=True, seed=3, lost_stripes=1).run(4)

    def test_lost_beyond_parity_rejected(self):
        params = ClusterParams(ckpt_placement="erasure", erasure_m=2)
        with pytest.raises(ValueError, match="unrecoverable"):
            StartupWorkload(bootseer=True, seed=3, params=params,
                            lost_stripes=3).run(4)


def test_simcluster_restore_ahead_and_delta_chain():
    base = StartupWorkload(bootseer=True, seed=3).run(32)
    covered = StartupWorkload(bootseer=True, seed=3,
                              restore_ahead_coverage=1.0).run(32)
    mi = "model_init"
    assert covered["restore_ahead_local_bytes"] > 0
    assert base["restore_ahead_local_bytes"] == 0
    assert max(covered["stages"][mi].values()) \
        < max(base["stages"][mi].values())
    chained = StartupWorkload(bootseer=True, seed=3,
                              delta_chain_len=4).run(32)
    assert max(chained["stages"][mi].values()) \
        > max(base["stages"][mi].values())
    cold = StartupWorkload(bootseer=False, seed=3,
                           restore_ahead_coverage=1.0,
                           delta_chain_len=4).run(32)
    assert cold["restore_ahead_local_bytes"] == 0


def test_simcluster_autotune_modelling():
    base = StartupWorkload(bootseer=False, autotune=True).run(16, 1)
    cold = StartupWorkload(bootseer=True, autotune=True).run(16, 0)
    warm = StartupWorkload(bootseer=True, autotune=True).run(16, 1)
    off = StartupWorkload(bootseer=False, autotune=False).run(16, 1)
    assert base["tune_gating"] and not cold["tune_gating"]
    assert warm["tune_cache_hit"] and not cold["tune_cache_hit"]
    assert base["job_level"] > off["job_level"] \
        + 0.9 * StartupWorkload().params.tune_sweep_s
    assert warm["tune_s"] < 0.01
