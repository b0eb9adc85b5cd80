"""The dry run on the production meshes (``launch/dryrun.py --multi-pod``,
``--both-meshes``): each mesh in a process of its own over a ``"fake"``
group of 256 or 512 ranks, the model's sharded path counted on rank 0's
shards. The records' schema, per-device FLOPs the one-card count over the
devices (the reference's convention), collective bytes by kind, and the
knobs' effect: ``--param-gather-dtype bfloat16`` halves the parameters'
all-gathers, ``--moe-sharding ep`` holds E / 16 experts a rank."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _dryrun(tmp_path: Path, *args, tiny: bool = True) -> list[dict]:
    out = tmp_path / f"dr-{abs(hash(args))}.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out), *(("--tiny",) if tiny else ()), *args],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert "0 failed" in res.stdout
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_meshes")
    return _dryrun(tmp, "--both-meshes", "--arch", "qwen2.5-3b", "--shape",
                   "train_4k")


def test_both_meshes_records(both):
    assert [(r["mesh"], r["chips"]) for r in both] == [
        ("16x16", 256), ("2x16x16", 512)]
    for r in both:
        assert r["step_kind"] == "train" and r["tiny"]
        assert r["moe_sharding"] == "tp" and r["param_gather_dtype"] == \
            "float32"
        roof = r["roofline"]
        assert roof["mesh"] == r["mesh"] and roof["chips"] == r["chips"]
        assert roof["memory_per_device_bytes"] == \
            r["memory"]["peak_memory_in_bytes"] > 0
        for k in ("compute_s", "memory_s", "collective_s"):
            assert roof[k] >= 0


def test_flops_per_device_are_the_one_card_count_over_the_devices(both):
    for r in both:
        glob = r["cost_analytic_global"]
        assert r["cost"]["flops"] == pytest.approx(glob["flops"] / r["chips"])
        assert r["cost"]["flops_fp32"] == pytest.approx(
            glob["flops_fp32"] / r["chips"])
        assert r["roofline"]["hlo_flops_per_device"] == r["cost"]["flops"]


def test_a_training_step_moves_collective_bytes(both):
    for r in both:
        coll = r["collectives"]
        assert coll["total"] > 0
        # FSDP gathers, partial sums, and q/k/v moved from head- to
        # sequence-sharded by one all-to-all each
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert coll["all-to-all"] > 0
        assert coll["total"] == pytest.approx(sum(
            v for k, v in coll.items() if k != "total"))
        assert r["roofline"]["collective_bytes_per_device"] == coll["total"]
    # twice the devices, half the batch rows and parameter shards a device
    assert both[1]["memory"]["peak_memory_in_bytes"] < \
        both[0]["memory"]["peak_memory_in_bytes"]


def test_multi_pod_and_knobs(tmp_path):
    """``--multi-pod`` alone runs 2x16x16; ``--param-gather-dtype
    bfloat16`` casts before the gather, so the all-gathers move fewer
    bytes; ``--moe-sharding ep`` and ``--serving-layout`` and
    ``--seq-sharded-acts`` run and are recorded."""
    base = _dryrun(tmp_path, "--multi-pod", "--arch", "qwen2.5-3b",
                   "--shape", "train_4k")
    bf16 = _dryrun(tmp_path, "--multi-pod", "--arch", "qwen2.5-3b",
                   "--shape", "train_4k", "--param-gather-dtype", "bfloat16")
    assert [r["mesh"] for r in base] == ["2x16x16"]
    assert bf16[0]["param_gather_dtype"] == "bfloat16"
    assert bf16[0]["collectives"]["all-gather"] < \
        base[0]["collectives"]["all-gather"]
    ep = _dryrun(tmp_path, "--multi-pod", "--arch", "mixtral-8x22b",
                 "--shape", "prefill_32k", "--moe-sharding", "ep",
                 "--seq-sharded-acts")
    assert ep[0]["moe_sharding"] == "ep" and ep[0]["seq_sharded_acts"]
    # the serving layout shards the ring over all 512 devices: the full
    # size's 32,768 slots divide, the tiny shape's 256 do not
    serve = _dryrun(tmp_path, "--multi-pod", "--arch", "qwen2.5-3b",
                    "--shape", "decode_32k", "--serving-layout", tiny=False)
    assert serve[0]["serving_layout"] and serve[0]["step_kind"] == "decode"
