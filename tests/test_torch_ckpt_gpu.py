"""The checkpoint paths that run only with a card: a save from card tensors
(copied to the host through one pinned buffer) and a restore onto the card
(read through a ring of pinned buffers, each copied on while the next is
read). Both are held bit for bit against the CPU's paths, which
tests/test_torch_ckpt.py holds against the JAX package. This file imports
no JAX, so it runs as it is on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ckpt_gpu.py
"""

import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.pipeline import IOScheduler
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.dfs.striped import StripedReader
from repro_torch.optim.adamw import tree_leaves, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned-memory paths have no CPU "
                    "mode")
    return torch.device("cuda")


def _trees():
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(300, 64, generator=gen),
              "layers": {"w": torch.randn(3, 64, 96, generator=gen),
                         "b": torch.randn(3, 96, generator=gen)
                         .to(torch.bfloat16)},
              "norm": torch.ones(64)}
    opt = {"mu": tree_map(lambda t: t.float() * 0.5, params),
           "step": torch.tensor(4, dtype=torch.int32)}
    return params, opt


@pytest.mark.gpu
@pytest.mark.parametrize("piece", [4096, 1 << 20])
def test_save_from_the_card_writes_the_cpus_files(tmp_path, cuda,
                                                  monkeypatch, piece):
    """Pieces smaller than a leaf exercise the pinned buffer's reuse."""
    monkeypatch.setattr(ckpt_mod, "PIECE_BYTES", piece)
    trees = _trees()
    files = []
    for name, tt in (("cpu", trees),
                     ("card", tuple(tree_map(lambda t: t.to(cuda), t)
                                    for t in trees))):
        ck = Checkpointer(HdfsCluster(tmp_path / name), width=4, chunk=4096,
                          stripe=16384)
        idx = ck.save(2, *tt)
        files.append((idx.to_json(),
                      StripedReader(ck.hdfs, ck.data_path(2)).read_all()))
    assert files[0] == files[1]


@pytest.mark.gpu
@pytest.mark.parametrize("async_tail", [False, True])
def test_restore_onto_the_card_through_the_ring(tmp_path, cuda, monkeypatch,
                                                async_tail):
    """Reads of at most 4 KiB into ring slots of 8 KiB make each slot
    refill many times; every leaf lands on the card bit-equal to the CPU's
    restore."""
    monkeypatch.setattr(ckpt_mod, "RING_BYTES", 8192)
    trees = _trees()
    ck = Checkpointer(HdfsCluster(tmp_path / "h"), width=4, chunk=4096,
                      stripe=16384)
    ck.save(2, *trees)
    host = ck.restore_planned(2, *trees)
    out = ck.restore_planned(2, *trees, device=cuda, sched=IOScheduler(),
                             async_tail=async_tail, max_read=4096)
    if async_tail:
        out = (out[0], *out[1].result())
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(host), tree_leaves(out)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b.cpu())
    assert ck.timings["wave0_read_s"] > 0 and "wave0_copy_s" in ck.timings
