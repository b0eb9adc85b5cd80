"""The port's kernel autotuning against the JAX package's, on the CPU:
``repro_torch.tune.prune`` and ``autotune`` (``src/repro/tune/``), and the
launch-config resolution of ``repro_torch.kernels.ops``
(``src/repro/kernels/ops.py``).

The CPU's sweeps run the plain versions that take the same knobs as the
kernels (``chunked_attention``'s q and k chunks, ``ssd_chunked``'s chunk)
over the JAX package's candidate grid; the card's sweeps take the compiled
instances, and the tests that launch them carry the ``gpu`` marker in
tests/test_torch_kernels.py. The resolution on the card is exercised here
on ``meta`` tensors, with the card's name and the kernel replaced, so
that only the config the wrapper would be handed is observed. Winners
are held to the plain version by the worst row's relative L2 error
(``autotune.ROW_RTOL``, 1e-3 in fp32: the chunked plain versions differ
from the reference by their order of summation alone).
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_io_witness

from repro.kernels import ops as jops
from repro.tune import autotune as jautotune
from repro.tune import prune as jprune
from repro.tune.profile import TuningProfile as JTuningProfile
from repro.tune.profile import use_profile as juse_profile
from repro_torch.core.pipeline import DEFERRED, IOScheduler
from repro_torch.dfs.fuse import HdfsFuseMount
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ssd
from repro_torch.kernels.ref import attention_reference, row_rel_err
from repro_torch.models.attention import chunked_attention
from repro_torch.models.ssm import ssd_chunked, ssd_reference
from repro_torch.tune import (ProfileStore, TuningProfile, attention_key,
                              autotune, prune, ssd_key, use_profile)
from repro_torch.tune.store import HEAD_PATH

ROOT = Path(__file__).resolve().parents[1]
CARD = "cuda-sm_90a:test card"


@pytest.fixture()
def mount(tmp_path):
    return HdfsFuseMount(HdfsCluster(tmp_path / "hdfs", num_groups=4,
                                     block_size=1 << 20))


# ------------------------------------------------------------- pruning ---

PRICES = {
    "bowl": lambda c: (c["block_q"] - 64) ** 2 + c["block_k"],
    "steps": lambda c: 1e6 / c["block_q"] / c["block_k"],
    "ties": lambda c: c["block_q"] // 64,
    "raises": lambda c: 1 / (c["block_k"] - 32),
}


@pytest.mark.parametrize("keep", [1, 2, 5, 100])
@pytest.mark.parametrize("price", sorted(PRICES))
def test_prune_ranks_as_the_reference(price, keep):
    """The same candidates, price function and keep give the same ranked
    survivors; a candidate whose price raises is dropped in both."""
    cands = jautotune.attention_candidates(256, 256)
    assert prune.prune_candidates(cands, PRICES[price], keep) == \
        jprune.prune_candidates(cands, PRICES[price], keep)


# ---------------------------------------------------------- candidates ---

@pytest.mark.parametrize("sq,sk", [(16, 16), (32, 32), (100, 100), (64, 512),
                                   (300, 40), (1024, 1024), (4096, 2048)])
def test_cpu_attention_candidates_are_the_references(sq, sk):
    assert autotune.attention_candidates(sq, sk) == \
        jautotune.attention_candidates(sq, sk)


@pytest.mark.parametrize("s", [16, 32, 50, 100, 128, 256, 1024, 4096])
def test_cpu_ssd_candidates_are_the_references(s):
    assert autotune.ssd_candidates(s) == jautotune.ssd_candidates(s)


def test_card_candidates_are_the_compiled_instances():
    """On the card the candidates are the library's instances whose tiles
    fit the shape's bucket; the default joins every sweep."""
    for d in (64, 128):
        assert autotune.attention_candidates(1024, 1024, head_dim=d) == [
            {"block_q": bq, "block_k": bk} for bq, bk in flash.CONFIGS[d]]
    assert autotune.attention_candidates(64, 64, head_dim=64) == [
        {"block_q": 64, "block_k": 64}]
    assert autotune.attention_candidates(100, 1000, head_dim=64) == [
        {"block_q": 128, "block_k": 64}, {"block_q": 64, "block_k": 64}]
    assert autotune.attention_candidates(2048, 2048, head_dim=128) == [
        {"block_q": 128, "block_k": 64}]
    assert autotune.ssd_candidates(1024, state_dim=128) == [
        {"chunk": 32}, {"chunk": 16}]
    assert autotune.ssd_candidates(16, state_dim=64) == [{"chunk": 16}]
    assert autotune.DEFAULT_CARD_ATTENTION == {"block_q": 128,
                                               "block_k": 64}
    assert autotune.DEFAULT_CARD_SSD == {"chunk": 32}


# ---------------------------------------------------------- resolution ---

KEY = attention_key(sq=128, sk=128, d=64, g=2, dtype="bfloat16",
                    causal=True, window=0, backend=CARD)
SSD_KEY = ssd_key(s=1024, h=32, p=64, g=1, n=128, dtype="bfloat16",
                  backend=CARD)
ATTN_DEFAULTS = {"block_q": 128, "block_k": 64}
# (kernel, key looked up, entries recorded, supplied kwargs, defaults)
RESOLVE_CASES = {
    "no profile": ("flash_attention", KEY, None, {}, ATTN_DEFAULTS),
    "hit": ("flash_attention", KEY, {KEY: {"block_q": 64, "block_k": 64}},
            {}, ATTN_DEFAULTS),
    "partial entry": ("flash_attention", KEY, {KEY: {"block_k": 128}}, {},
                      ATTN_DEFAULTS),
    "supplied wins": ("flash_attention", KEY,
                      {KEY: {"block_q": 64, "block_k": 64}},
                      {"block_q": 128, "block_k": None}, ATTN_DEFAULTS),
    "miss": ("flash_attention", KEY, {SSD_KEY: {"chunk": 16}}, {},
             ATTN_DEFAULTS),
    "foreign field": ("flash_attention", KEY,
                      {KEY: {"block_q": 64, "chunk": 7}}, {}, ATTN_DEFAULTS),
    "ssd hit": ("ssd", SSD_KEY, {SSD_KEY: {"chunk": 16}}, {}, {"chunk": 32}),
    "ssd supplied": ("ssd", SSD_KEY, {SSD_KEY: {"chunk": 16}},
                     {"chunk": 32}, {"chunk": 32}),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_picks_as_the_reference(case):
    """Supplied kwargs > the ambient profile > defaults, field by field:
    the profile is built with the JAX package's TuningProfile, and its JSON
    loaded into the port's; both packages' ``_resolve`` pick the same
    config and count the same hit or miss."""
    kernel, key, entries, supplied, defaults = RESOLVE_CASES[case]
    jprof = pprof = None
    if entries is not None:
        jprof = JTuningProfile(backend=CARD)
        for k, cfg in entries.items():
            jprof.record(k, cfg, measured_s=1e-4)
        pprof = TuningProfile.from_json(jprof.to_json())
        assert pprof.digest() == jprof.digest()
    j0, p0 = dict(jops.stats), dict(ops.stats)
    with juse_profile(jprof):
        want = jops._resolve(kernel, key, dict(supplied), dict(defaults), {})
    with use_profile(pprof):
        got = ops._resolve(kernel, key, dict(supplied), dict(defaults), {})
    assert got == want
    for name in ("profile_hits", "profile_misses", "miss_tunes"):
        assert ops.stats[name] - p0[name] == jops.stats[name] - j0[name]


@pytest.fixture()
def on_card(monkeypatch):
    """ops' card path on ``meta`` tensors: the card's name fixed (a meta
    tensor names none, so it would take the defaults), the kernels'
    operators replaced by recorders of the config they are handed."""
    calls = []
    monkeypatch.setattr(ops, "card_backend", lambda device=None: CARD)

    def flash_rec(q, k, v, causal, window, q_offset, block_q, block_k,
                  return_lse):
        calls.append(("flash_attention", block_q, block_k))
        return q, None

    def ssd_rec(x, dt, A, B, C, D, chunk, bf16_intra=False):
        calls.append(("ssd", chunk))
        return x, None

    monkeypatch.setattr(ops, "flash_attention_fwd_op", flash_rec)
    monkeypatch.setattr(ops, "ssd_fwd_op", ssd_rec)
    return calls


def _meta_ssd(b=8, s=1024, h=32, p=64, g=1, n=128):
    m = dict(device="meta")
    return (torch.empty((b, s, h, p), dtype=torch.bfloat16, **m),
            torch.empty((b, s, h), **m), torch.empty((h,), **m),
            torch.empty((b, s, g, n), dtype=torch.bfloat16, **m),
            torch.empty((b, s, g, n), dtype=torch.bfloat16, **m),
            torch.empty((h,), **m))


@pytest.mark.parametrize("entry,want", [(None, 32), ({"chunk": 16}, 16)])
def test_model_chunk_does_not_reach_the_kernel(on_card, entry, want):
    """The model hands ssd_op its config's chunk (256), the plain version's;
    on the card the tile comes from the profile or the kernel's default,
    never from that chunk."""
    prof = TuningProfile(backend=CARD)
    if entry is not None:
        prof.record(SSD_KEY, entry)
    with use_profile(prof):
        ops.ssd_op(*_meta_ssd(), chunk=256)
    assert on_card == [("ssd", want)]


def test_attention_op_resolves_on_the_card(on_card):
    """The profile's entry reaches the kernel; a caller's block_q wins
    over it field by field; with no profile the default config."""
    q = torch.empty((2, 128, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    prof = TuningProfile(backend=CARD)
    prof.record(KEY, {"block_q": 64, "block_k": 64})
    ops.attention_op(q, kv, kv)
    with use_profile(prof):
        ops.attention_op(q, kv, kv)
        ops.attention_op(q, kv, kv, block_q=128)
    other = TuningProfile(backend="cuda-sm_90a:another card")
    other.record(KEY.replace(CARD, other.backend),
                 {"block_q": 64, "block_k": 64})
    with use_profile(other):  # tuned on another card: a miss here
        ops.attention_op(q, kv, kv)
    assert on_card == [("flash_attention", 128, 64),
                       ("flash_attention", 64, 64),
                       ("flash_attention", 128, 64),
                       ("flash_attention", 128, 64)]


def test_a_profile_naming_no_instance_raises(monkeypatch):
    """A profile entry for a config the library lacks reaches the wrapper,
    which raises before any launch; it is never replaced by the default."""
    monkeypatch.setattr(ops, "card_backend", lambda device=None: CARD)
    q = torch.empty((2, 128, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    prof = TuningProfile(backend=CARD)
    prof.record(KEY, {"block_q": 32, "block_k": 32})
    prof.record(SSD_KEY, {"chunk": 64})
    with use_profile(prof):
        with pytest.raises(ValueError, match="no compiled instance"):
            ops.attention_op(q, kv, kv)
        with pytest.raises(ValueError, match="no compiled instance"):
            ops.ssd_op(*_meta_ssd(), chunk=256)


# configs with no instance; (64, 128, 128) and (128, 64, 64) spill, so
# csrc/flash_attention.cu does not compile them
BAD_FLASH = [(64, 32, 32), (64, 256, 64), (64, 128, 128), (128, 64, 64),
             (128, 128, 128)]


@pytest.mark.parametrize("d,bq,bk", BAD_FLASH)
def test_unknown_flash_config_raises_before_any_cuda_call(monkeypatch, d, bq,
                                                          bk):
    def no_build(*a, **k):
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "build", no_build)
    q = torch.zeros((1, 64, 2, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no compiled instance"):
        flash.flash_attention(q, q, q, block_q=bq, block_k=bk)


@pytest.mark.parametrize("n,chunk", [(128, 64), (64, 8), (16, 256)])
def test_unknown_ssd_tile_raises_before_any_cuda_call(monkeypatch, n, chunk):
    def no_build(*a, **k):
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "build", no_build)
    x, dt, A, B, C, D = (torch.zeros(t.shape, dtype=t.dtype)
                         for t in _meta_ssd(1, 40, 2, 32, 1, n))
    with pytest.raises(ValueError, match="no compiled instance"):
        ssd.ssd_chunked_kernel(x, dt, A, B, C, D, chunk=chunk)


def test_cpu_tensors_take_no_launch_config():
    """On the CPU the plain version runs: a profile is not consulted and a
    launch config is refused."""
    x = torch.randn((1, 32, 2, 16))
    prof = TuningProfile(backend=CARD)
    h0 = dict(ops.stats)
    with use_profile(prof):
        out = ops.attention_op(x, x, x)
    assert torch.equal(out, ops.attention_op(x, x, x))
    assert ops.stats == h0 and prof.stats["hits"] == prof.stats["misses"] == 0
    with pytest.raises(ValueError, match="launch config"):
        ops.attention_op(x, x, x, block_q=64)


def test_corrupt_stored_profile_degrades_to_defaults(mount, on_card):
    """A corrupt DFS artifact means the defaults, not a crash, and no
    profile means no miss counted (as the JAX package's test)."""
    prof = TuningProfile(backend=CARD)
    prof.record(SSD_KEY, {"chunk": 16})
    store = ProfileStore(mount)
    store.publish(prof)
    mount.write(HEAD_PATH, b"deadbeef")  # a dangling HEAD
    assert store.fetch() is None and store.stats["rejects"] == 1
    m0 = ops.stats["profile_misses"]
    with use_profile(store.fetch()):
        ops.ssd_op(*_meta_ssd(), chunk=256)
    assert on_card == [("ssd", 32)]
    assert ops.stats["profile_misses"] == m0


# ----------------------------------------------------------- the sweep ---

def _check_entry(key, entry):
    """Re-run the plain version at the winner and hold it to the
    reference, as the sweep did."""
    if key.startswith("flash_attention"):
        wl = autotune.tiny_workloads()[0]
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((wl["b"], wl["sq"], h, wl["d"]), generator=gen)
                   for h in (wl["hq"], wl["hkv"], wl["hkv"]))
        pos = torch.arange(wl["sq"])
        out = chunked_attention(q, k, v, pos, pos,
                                q_chunk=entry["config"]["block_q"],
                                k_chunk=entry["config"]["block_k"])
        ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)))
        return row_rel_err(out, ref.transpose(1, 2))
    wl = autotune.tiny_workloads()[1]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, wl["s"], wl["h"], wl["p"]), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((1, wl["s"], wl["h"]),
                                                  generator=gen))
    A = -torch.exp(torch.rand((wl["h"],), generator=gen))
    B = torch.randn((1, wl["s"], 1, wl["n"]), generator=gen) * 0.5
    C = torch.randn((1, wl["s"], 1, wl["n"]), generator=gen) * 0.5
    D = torch.ones((wl["h"],))
    y, st = ssd_chunked(x, dt, A, B, C, D, chunk=entry["config"]["chunk"],
                        return_state=True)
    y_ref, st_ref = ssd_reference(x, dt, A, B, C, D)
    return max(row_rel_err(y, y_ref), row_rel_err(st, st_ref))


def test_cpu_sweep_records_verified_winners_and_round_trips(mount):
    """One sweep per workload; each winner, run again, passes the plain
    version's check; the profile published through the port's store
    comes back with the same digest and resolves the same configs."""
    t0 = autotune.stats["tune_invocations"]
    prof = autotune.build_profile(autotune.tiny_workloads(),
                                  backend=autotune.CPU_BACKEND, repeats=1)
    assert autotune.stats["tune_invocations"] - t0 == 2
    assert prof.backend == autotune.CPU_BACKEND and len(prof.entries) == 2
    for key, entry in prof.entries.items():
        assert key.endswith("|float32|cpu")
        assert entry["measured_s"] <= entry["default_s"]
        assert _check_entry(key, entry) <= autotune.ROW_RTOL["float32"]
    store = ProfileStore(mount)
    pub = store.publish(prof)
    back = store.fetch()
    assert back is not None and back.digest() == pub["digest"] == prof.digest()
    assert {k: back.resolve(k) for k in prof.entries} == \
        {k: e["config"] for k, e in prof.entries.items()}


@pytest.mark.parametrize("keep", [1, 3])
def test_sweep_prunes_to_keep_and_the_default(keep):
    """Of the 16 candidates at S = 256 only ``keep`` reach measurement,
    with the default; the winner is the fastest measured."""
    p0 = autotune.stats["pruned"]
    _, entry = autotune.tune_attention(sq=256, d=16, hq=2, hkv=1,
                                       prune_keep=keep, repeats=1,
                                       backend=autotune.CPU_BACKEND)
    assert entry["candidates"] == 16
    assert entry["measured"] in (keep, keep + 1)
    assert autotune.stats["pruned"] - p0 == 16 - entry["measured"]
    assert entry["measured_s"] <= entry["default_s"]


def test_cpu_attention_sweep_is_causal_only():
    with pytest.raises(ValueError, match="causal"):
        autotune.tune_attention(sq=32, d=16, causal=False,
                                backend=autotune.CPU_BACKEND)


@pytest.mark.parametrize("sweep", ["tune_attention", "tune_ssd"])
def test_bare_sweep_asks_for_the_card(sweep, monkeypatch):
    """Called bare, a sweep resolves the card's backend, as
    ``tune_workload`` does: on a torch without CUDA that raises before
    any plain version is swept; with the card's name stubbed it still
    asks for the card and sweeps nothing on the CPU."""
    swept = []
    for plain in ("chunked_attention", "ssd_chunked_reference"):
        monkeypatch.setattr(autotune, plain,
                            lambda *a, _p=plain, **k: swept.append(_p))
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            getattr(autotune, sweep)()
    asked = []

    def no_card():
        asked.append(True)
        raise RuntimeError("no card here")

    monkeypatch.setattr(autotune, "card_backend", no_card)
    with pytest.raises(RuntimeError, match="no card here"):
        getattr(autotune, sweep)()
    assert asked == [True] and swept == []


def test_card_backend_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert ops.card_backend() == "cuda-sm_90a:NVIDIA H100 80GB HBM3"
    assert ops.dtype_name(torch.bfloat16) == "bfloat16"


def test_tune_loads_the_sweep_lazily():
    """``repro_torch.tune`` keeps torch out of its light imports; the
    sweep and the pruning load on first access, as the JAX package's."""
    code = ("import sys; import repro_torch.tune as t; "
            "assert 'repro_torch.tune.autotune' not in sys.modules; "
            "assert 'torch' not in sys.modules; "
            "assert t.autotune.stats['tune_invocations'] == 0; "
            "assert t.prune.LAUNCH_OVERHEAD_S > 0")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": "src", "PATH": ""}, cwd=ROOT)


# ------------------------------------------------------ record-on-miss ---

def _miss_kwargs():
    wl = dict(autotune.tiny_workloads()[0])
    del wl["kernel"], wl["prune_keep"]
    return dict(wl, sk=wl["sq"], dtype="float32", causal=True, window=0)


def _miss_key():
    wl = _miss_kwargs()
    return attention_key(sq=wl["sq"], sk=wl["sk"], d=wl["d"],
                         g=wl["hq"] // wl["hkv"], dtype="float32",
                         causal=True, window=0, backend=autotune.CPU_BACKEND)


def test_record_on_miss_tunes_once_and_publishes(mount):
    """A profile with ``tune_on_miss`` tunes an unseen key on its first
    resolution, records it and publishes the profile through its store;
    the next resolution of the key is a hit, with no sweep."""
    prof = TuningProfile(backend=autotune.CPU_BACKEND)
    prof.tune_on_miss = True
    prof.store = ProfileStore(mount)
    t0, m0 = autotune.stats["tune_invocations"], ops.stats["miss_tunes"]
    with use_profile(prof):
        cfg = ops._resolve("flash_attention", _miss_key(), {},
                           {"block_q": 128, "block_k": 128}, _miss_kwargs())
        again = ops._resolve("flash_attention", _miss_key(), {},
                             {"block_q": 128, "block_k": 128},
                             _miss_kwargs())
    assert autotune.stats["tune_invocations"] == t0 + 1
    assert ops.stats["miss_tunes"] == m0 + 1
    assert cfg == again == prof.entries[_miss_key()]["config"]
    fetched = prof.store.fetch()
    assert fetched is not None and fetched.digest() == prof.digest()
    assert prof.store.stats["publishes"] == 1


def test_store_io_is_metered_in_slots(mount, monkeypatch):
    """The record-on-miss publish and a later fetch move every byte inside
    a "dfs" slot at the store's priority, DEFERRED, as metered
    (tests/torch_io_witness.py)."""
    witness = torch_io_witness.install(monkeypatch)
    sched = IOScheduler()
    prof = TuningProfile(backend=autotune.CPU_BACKEND)
    prof.tune_on_miss = True
    prof.store = ProfileStore(mount, sched=sched)
    with use_profile(prof):
        ops._resolve("flash_attention", _miss_key(), {},
                     {"block_q": 128, "block_k": 128}, _miss_kwargs())
    assert prof.store.fetch().digest() == prof.digest()
    witness.check_scheduler(sched, writes=True)
    written = prof.store.stats["bytes_written"]
    assert witness.written == {DEFERRED: written}
    assert witness.read == {DEFERRED: written}


def test_the_witness_catches_an_unmetered_write(mount, monkeypatch):
    witness = torch_io_witness.install(monkeypatch)
    sched = IOScheduler()
    store = ProfileStore(mount, sched=sched)
    store.publish(TuningProfile(backend=autotune.CPU_BACKEND))
    witness.check_scheduler(sched, writes=True)
    mount.write(HEAD_PATH, b"0" * 64)  # outside any slot
    with pytest.raises(AssertionError, match="outside any dfs slot"):
        witness.check_scheduler(sched, writes=True)

