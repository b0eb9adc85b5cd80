"""The port's roofline (``repro_torch.roofline``) against the JAX package's
``roofline/analysis.py`` and against the kernels' own tiling rules: the
H100's constants, ``model_flops`` and ``RooflineReport`` as the
reference's, the kernels' bounds at the shapes of PERF.md's kernel table
(the figures ``chip_smoke.py`` prints beside each kernel's time), and the
cost model the autotuner's pruning prices launch configs with.

The bounds are compared to 1e-4 ms: PERF.md gives them to four places.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.roofline import analysis, kernel_cost
from repro_torch.tune import prune

ARCHS = ["qwen2.5-3b", "mamba2-370m", "zamba2-1.2b", "moonshot-v1-16b-a3b",
         "musicgen-large", "qwen2-vl-72b"]


def test_constants_are_the_h100s():
    """bf16 dense peak, fp32 outside the tensor cores, HBM3, NVLink each
    way: none of them the TPU's."""
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.PEAK_FP32_FLOPS == 67e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        assert getattr(analysis, name) != getattr(janalysis, name)


def test_report_has_the_references_fields():
    assert [f.name for f in dataclasses.fields(analysis.RooflineReport)] == \
        [f.name for f in dataclasses.fields(janalysis.RooflineReport)]
    kw = {f.name: 1 for f in dataclasses.fields(analysis.RooflineReport)}
    assert analysis.RooflineReport(**kw).to_json() == \
        janalysis.RooflineReport(**kw).to_json()


@pytest.mark.parametrize("step_kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_as_the_reference(arch, step_kind):
    shape = dict(name="s", seq_len=2048, global_batch=8, kind=step_kind)
    got = analysis.model_flops(get_config(arch), ShapeConfig(**shape),
                               step_kind=step_kind)
    want = janalysis.model_flops(jget_config(arch), JShapeConfig(**shape),
                                 step_kind=step_kind)
    assert got == want


# PERF.md's kernel table: (function, its arguments, bound ms, bound by)
BOUNDS = [
    ("attention_bound", (8, 16, 2, 1024, 128), 0.0348, "operations"),
    ("ssd_bound", (8, 1024, 32, 64, 1, 128), 0.0241, "bytes"),
    ("attention_bwd_bound", (2, 16, 2, 2048, 128,
                             kernel_cost.unmasked_pairs(2048, 2048, True, 0)),
     0.0869, "operations"),
    ("ssd_bwd_bound", (8, 2048, 32, 64, 1, 128), 0.0664, "bytes"),
    # the newer models' rows
    ("attention_bound", (8, 32, 32, 1024, 64), 0.0401, "bytes"),
    ("attention_bound", (8, 64, 8, 1024, 128), 0.1391, "operations"),
    ("ssd_bound", (8, 1024, 64, 64, 1, 64), 0.0438, "bytes"),
    ("ssd_bwd_bound", (8, 2048, 64, 64, 1, 64), 0.1252, "bytes"),
]


@pytest.mark.parametrize("fn,args,ms,by", BOUNDS,
                         ids=[f"{b[0]}{b[1][:4]}" for b in BOUNDS])
def test_bounds_are_perf_mds(fn, args, ms, by):
    got_ms, got_by = getattr(kernel_cost, fn)(*args)
    assert abs(got_ms - ms) < 1e-4 and got_by == by


def test_unmasked_pairs_counts_the_masks():
    for sq, sk, causal, window in ((64, 64, True, 0), (50, 70, True, 0),
                                   (64, 64, True, 16), (40, 64, False, 0),
                                   (64, 30, True, 8)):
        q = np.arange(sq)[:, None]
        k = np.arange(sk)[None, :]
        ok = np.ones((sq, sk), bool)
        if causal:
            ok &= q >= k
        if window:
            ok &= k > q - window
        assert kernel_cost.unmasked_pairs(sq, sk, causal, window) == ok.sum()


def _walked_tiles(sq, sk, bq, bk, causal, window):
    """Key tiles each q tile walks, by csrc/flash_attention.cu's rules,
    one q tile at a time."""
    out = []
    for q_lo in range(0, sq, bq):
        end = -(-sk // bk)
        if causal:
            end = min(end, (q_lo + bq - 1) // bk + 1)
        begin = (q_lo - window + 1) // bk if window and q_lo - window + 1 > 0 \
            else 0
        out.append(max(end - begin, 0))
    return out


@pytest.mark.parametrize("bq,bk", [(128, 64), (64, 64), (128, 128), (32, 256)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (1024, 1024, True, 0), (1000, 1000, True, 0), (1024, 1024, True, 256),
    (512, 700, False, 0), (2048, 2048, True, 4096)])
def test_flash_cost_walks_the_kernels_tiles(bq, bk, sq, sk, causal, window):
    """FLOPs are 4 d per (q, k) of every whole tile walked; bytes the Q and
    O tiles once and a K and a V tile per key tile, so the K/V re-reads
    grow as block_q shrinks; the steps spread the blocks' chains over the
    card's block slots, never fewer than the longest chain."""
    b, hq, d = 2, 4, 64
    tiles = _walked_tiles(sq, sk, bq, bk, causal, window)
    flops, nbytes, steps = kernel_cost.flash_cost(
        b, hq, 1, sq, sk, d, causal=causal, window=window, block_q=bq,
        block_k=bk)
    heads = b * hq
    assert flops * steps == pytest.approx(4 * d * bq * bk * sum(tiles) * heads)
    assert nbytes * steps == pytest.approx(
        2 * d * (2 * bq * len(tiles) + 2 * bk * sum(tiles)) * heads)
    slots = kernel_cost.SMS * (2 if bq <= 64 else 1)
    assert steps == max(-(-sum(tiles) * heads // slots), max(tiles), 1)


def test_smaller_q_tiles_read_k_and_v_more_often():
    shape = dict(b=8, hq=32, hkv=32, sq=1024, sk=1024, d=64)
    total = {bq: np.prod(kernel_cost.flash_cost(**shape, block_q=bq,
                                                block_k=64)[1:])
             for bq in (64, 128)}
    assert total[64] > total[128]


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("b,s,h", [(8, 1024, 32), (8, 1000, 64), (1, 32, 2)])
def test_ssd_cost_walks_the_tiles_per_batch_and_head(chunk, b, s, h):
    """One block per (batch, head), a step per tile of its chain, two
    blocks to an SM: 256 blocks fit the card's 264 slots at once, so their
    steps are the tiles; 512 spread their tiles over the slots."""
    p, n = 64, 128
    flops, nbytes, steps = kernel_cost.ssd_cost(b, s, h, p, 1, n, chunk=chunk)
    tiles = -(-s // chunk)
    pairs = chunk * (chunk + 1) // 2
    assert steps == max(-(-b * h * tiles // (2 * kernel_cost.SMS)), tiles)
    if b * h <= 2 * kernel_cost.SMS:
        assert steps == tiles
    assert flops * steps == pytest.approx(
        b * h * tiles * (2 * pairs * (n + p) + 4 * chunk * n * p))
    assert nbytes * steps == pytest.approx(
        b * h * (tiles * chunk * (4 * p + 4 + 4 * n) + 4 * p * n))


def test_predict_seconds_sums_the_steps():
    shape = dict(b=8, s=1024, h=32, p=64, g=1, n=128)
    flops, nbytes, steps = kernel_cost.ssd_cost(**shape, chunk=16)
    assert prune.predict_seconds("ssd", {"chunk": 16}, **shape) == \
        pytest.approx(steps * (flops / analysis.PEAK_FLOPS
                               + nbytes / analysis.HBM_BW
                               + prune.LAUNCH_OVERHEAD_S))
    # more serial tiles cost more: the tile of 16 ranks below 32's
    assert prune.predict_seconds("ssd", {"chunk": 16}, **shape) > \
        prune.predict_seconds("ssd", {"chunk": 32}, **shape)
