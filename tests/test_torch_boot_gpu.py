"""The kernel library as the job's snapshotted environment, on a machine
with a card and ``nvcc``: built into an env target, snapshotted into the
env cache, restored into another directory byte for byte (its ptxas log
too), and loaded from there. tests/test_torch_boot.py holds the same path
on the CPU with ``build.build`` replaced. This file imports no JAX, so it
runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_boot_gpu.py
"""

import ctypes

import pytest
import torch

from repro_torch.dfs.fuse import HdfsFuseMount
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.envcache.snapshot import EnvCache, job_cache_key, snapshot_dir
from repro_torch.kernels import build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel library is "
                    "built for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_restored_kernel_library_loads(tmp_path, cuda):
    target = tmp_path / "env"
    before = snapshot_dir(target)
    lib = build.compile_into(target / "kernels")
    log = lib.with_suffix(".log")
    cache = EnvCache(HdfsFuseMount(HdfsCluster(tmp_path / "hdfs")))
    key = job_cache_key({"kernels": build.source_hash()})
    meta = cache.create(key, target, before, {})
    assert meta["files"] == 2

    out = tmp_path / "restored"
    assert cache.restore(key, out) is not None
    got = out / "kernels" / lib.name
    assert got.read_bytes() == lib.read_bytes()
    assert (out / "kernels" / log.name).read_text() == log.read_text()
    loaded = ctypes.CDLL(str(got))
    for entry in ("repro_flash_attention_fwd_bf16", "repro_ssd_chunked_fwd_bf16"):
        assert getattr(loaded, entry) is not None
