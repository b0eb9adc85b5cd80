"""Four-rank rehearsal of the port's sharded path on the CPU, and the JAX
reference on the same mesh shape, for tests/test_torch_sharding_*.py.

``run_ranks(fn, cases, tmp_path)`` starts one process per device
(``torch.multiprocessing``, spawn), each in a gloo group over a
``FileStore`` in ``tmp_path`` (no port, so xdist workers run side by
side), one thread each, a timeout on the group and on the join, so that a
hung rank fails the test. For each case each rank calls ``fn(rules,
**case)`` on a ``DeviceMesh`` of ``case["mesh"]`` over ("data", "model")
with ``case["rules"]``.

``reference(cases, tmp_path)`` runs the JAX model for every case in one
subprocess with 4 forced host devices on an Auto-axis mesh of the case's
shape (``_reference_case``); ``rehearse`` runs both on the same weights
and inputs; ``port_rank`` and ``restore_rank`` are the ranks' bodies.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_TIMEOUT = 240


def _worker(rank, world, store_path, out_dir, fn, cases):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.rules import make_rules
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        meshes, outs = {}, []
        for case in cases:
            shape = tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = init_device_mesh(
                    "cpu", shape, mesh_dim_names=("data", "model"))
            kw = {k: v for k, v in case.items() if k not in ("mesh", "rules")}
            rules = make_rules(meshes[shape], **case.get("rules", {}))
            outs.append(fn(rules, **kw))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(outs, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(Path(out_dir) / f"rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, cases: list[dict], tmp_path: Path) -> list[list]:
    """For each rank, its outputs of ``fn(rules, **case)`` for each case
    (``rules`` from ``make_rules`` over a mesh of ``case["mesh"]`` with
    ``case["rules"]``); raises with the first failing rank's traceback,
    or after ``JOIN_TIMEOUT`` seconds."""
    import torch.multiprocessing as mp
    out_dir = Path(tmp_path) / f"ranks-{time.monotonic_ns()}"
    out_dir.mkdir(parents=True)
    ctx = mp.start_processes(
        _worker, args=(WORLD, str(out_dir / "store"), str(out_dir), fn,
                       cases),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not finish in {JOIN_TIMEOUT} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = sorted(out_dir.glob("rank*.err"))
        if errs:
            raise RuntimeError(errs[0].read_text()) from e
        raise
    outs = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def reference(cases: list[dict], tmp_path: Path) -> list[dict]:
    """The JAX reference's outputs for each case (``_reference_case``) on
    4 forced host devices, from one subprocess."""
    path = Path(tmp_path) / f"ref-{time.monotonic_ns()}.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch_sharding_harness as h; "
         "h._reference_main(sys.argv[1])", str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    with open(path.with_suffix(".out"), "rb") as f:
        return pickle.load(f)


def _reference_main(path: str) -> None:
    with open(path, "rb") as f:
        cases = pickle.load(f)
    outs = [_reference_case(**case) for case in cases]
    with open(Path(path).with_suffix(".out"), "wb") as f:
        pickle.dump(outs, f)


def _reference_case(*, arch: str, mesh, tokens, cache_len: int, train_tokens,
                    train_labels, decodes: int = 4, seed: int = 0,
                    overrides: dict | None = None, rules: dict | None = None,
                    opt: dict | None = None, extras: bool = False,
                    **_) -> dict:
    """The reference on an Auto-axis mesh of ``mesh``: the weights of
    ``seed``, prefill logits and ``decodes`` greedy decodes, the loss and
    its metrics, every gradient leaf and the params after one AdamW step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.configs.base import reduced
    from repro.models.model import Model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.sharding.rules import make_rules
    from repro.train.step import make_train_step

    jmesh = jax.make_mesh(tuple(mesh), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    cfg = reduced(get_config(arch), dtype="float32", **(overrides or {}))
    model = Model(cfg, make_rules(jmesh, **(rules or {})))
    params = model.init(jax.random.PRNGKey(seed))
    out = {"params": jax.tree.map(np.asarray, params)}
    logits, caches = jax.jit(
        lambda p, t: model.prefill(p, {"tokens": t}, cache_len=cache_len))(
            params, jnp.asarray(tokens))
    out["prefill"] = np.asarray(logits)
    pos = tokens.shape[1]
    dec = jax.jit(model.decode_step)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    decs, toks = [], []
    for _ in range(decodes):
        toks.append(np.asarray(nxt))
        lg, caches = dec(params, nxt[:, None], caches, jnp.int32(pos))
        decs.append(np.asarray(lg))
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
        pos += 1
    out["decodes"] = np.stack(decs)
    out["decode_tokens"] = np.stack(toks)
    batch = {"tokens": jnp.asarray(train_tokens),
             "labels": jnp.asarray(train_labels)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(params, batch)
    out.update(loss=np.asarray(loss), ce=np.asarray(metrics["ce"]),
               aux=np.asarray(metrics["aux"]),
               grads=jax.tree.map(np.asarray, grads))
    step = jax.jit(make_train_step(model, AdamWConfig(**(opt or {}))))
    stepped, _, _ = step(params, adamw_init(params), batch)
    out["stepped"] = jax.tree.map(np.asarray, stepped)
    if extras:
        from repro.data.loader import ShardedLoader
        from repro.data.synthetic import SyntheticStream
        got = ShardedLoader(SyntheticStream(cfg.vocab_size, 0), model.rules,
                            4, 16)(0)["tokens"]
        where = {d.id: tuple(int(i) for i in idx)
                 for idx, d in np.ndenumerate(jmesh.devices)}
        out["loader_shards"] = {where[sh.device.id]: np.asarray(sh.data)
                                for sh in got.addressable_shards}
    return out


def port_rank(rules, *, arch: str, params, tokens, cache_len: int,
              train_tokens, train_labels, decodes: int = 4,
              overrides: dict | None = None, opt: dict | None = None,
              extras: bool = False, **_) -> dict:
    """The port's outputs on this rank's mesh, the reference's weights
    sharded by ``shard_params``; every DTensor gathered."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import Model
    from repro_torch.models.sharded import shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
    from repro_torch.train.step import loss_and_grads, make_train_step

    cfg = reduced(get_config(arch), dtype="float32", **(overrides or {}))
    model = Model(cfg, rules)
    full = params_from_numpy(params, cfg, device="cpu", dtype=torch.float32)
    sharded = shard_params(full, rules, cfg)

    def gather(tree):
        return tree_map(lambda t: (t.full_tensor() if isinstance(t, DTensor)
                                   else t).detach().numpy(), tree)

    out = {}
    with torch.no_grad():
        logits, caches = model.prefill(
            sharded, {"tokens": torch.from_numpy(tokens)},
            cache_len=cache_len)
        logits = logits.full_tensor()
        out["prefill"] = logits.numpy()
        nxt = logits.argmax(-1).int()
        pos = tokens.shape[1]
        decs, toks = [], []
        for _ in range(decodes):
            toks.append(nxt.numpy())
            lg, caches = model.decode_step(sharded, nxt[:, None], caches, pos)
            lg = lg.full_tensor()
            decs.append(lg.numpy())
            nxt = lg.argmax(-1).int()
            pos += 1
        out["decodes"] = np.stack(decs)
        out["decode_tokens"] = np.stack(toks)
    if extras:      # before the train step updates the weights in place
        out.update(_port_extras(rules, model, sharded, tokens, cache_len))
    batch = {"tokens": torch.from_numpy(train_tokens),
             "labels": torch.from_numpy(train_labels)}
    grads = tree_map(torch.zeros_like, sharded)
    loss, metrics = loss_and_grads(model, sharded, batch, grads)
    out["loss"] = loss.numpy()
    out["ce"] = metrics["ce"].numpy()
    out["aux"] = metrics["aux"].numpy()
    out["grads"] = gather(grads)
    step = make_train_step(model, AdamWConfig(**(opt or {})))
    stepped, _, _ = step(sharded, adamw_init(sharded), batch)
    out["stepped"] = gather(stepped)
    return out


def _port_extras(rules, model, sharded, tokens, cache_len) -> dict:
    """``Model.init`` on the mesh (gathered), this rank's rows from the
    ``ShardedLoader`` with its mesh coordinates, and ``ServeEngine``'s
    greedy tokens on the sharded weights."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    init = model.init(torch.Generator().manual_seed(3), dtype=torch.float32)
    out = {"init": tree_map(lambda t: t.full_tensor().numpy(), init)}
    coords = rules.coords_of_rank(dist.get_rank())
    rows = ShardedLoader(SyntheticStream(model.cfg.vocab_size, 0), rules, 4,
                         16)(0)["tokens"]
    out["rank_rows"] = {(coords["data"], coords["model"]):
                        rows.to_local().numpy()}
    engine = ServeEngine(model, sharded, batch=4, cache_len=cache_len,
                         device=model.device)
    reqs = [Request(prompt=tokens[i], max_new_tokens=4) for i in range(4)]
    out["engine"] = np.array([r.generated for r in engine.generate(reqs)])
    return out


def rehearse(cases: list[dict], tmp_path: Path) -> list[tuple]:
    """Each case's (case, the reference's outputs, the port's rank-0
    outputs) on the same mesh shape and weights: the reference's for every
    case in one subprocess, the port's in one four-rank run. Inputs are
    drawn from seed 0: a prompt [4, 16], a training batch [4, 16]."""
    full = []
    for case in cases:
        rng = np.random.default_rng(case.get("seed", 0))
        vocab = 512

        def draw():
            return rng.integers(0, vocab, (4, 16)).astype(np.int32)

        full.append(dict(dict(cache_len=32, tokens=draw(),
                              train_tokens=draw(), train_labels=draw()),
                         **case))
    refs = reference(full, tmp_path)
    for case, ref in zip(full, refs):
        case["params"] = ref["params"]
    ports = run_ranks(port_rank, full, tmp_path)
    for rank in ports[1:]:      # every rank gathers the same results
        for a, b in zip(rank, ports[0]):
            assert worst({k: v for k, v in a.items() if k != "rank_rows"},
                         {k: v for k, v in b.items() if k != "rank_rows"}) \
                == 0.0
    for i, out in enumerate(ports[0]):      # each rank's own rows
        if "rank_rows" in out:
            out["rank_rows"] = {k: v for rank in ports
                                for k, v in rank[i]["rank_rows"].items()}
    return list(zip(full, refs, ports[0]))


def worst(a, b) -> float:
    """The largest absolute difference over two trees of arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max((worst(a[k], b[k]) for k in a), default=0.0)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def leaf_errors(a: dict, b: dict, prefix: str = "") -> dict:
    """{leaf path: largest absolute difference} over two trees."""
    out = {}
    for k in a:
        if isinstance(a[k], dict):
            out.update(leaf_errors(a[k], b[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = worst(a[k], b[k])
    return out


GEOMETRY = dict(width=4, chunk=4096, stripe=16384)


def restore_rank(rules, *, arch: str, root: str, params=None,
                 steps: tuple = (), **_) -> dict:
    """A checkpoint saved on the mesh (``params``, the reference's weights
    sharded: every rank gathers, rank 0 writes; step 1), then each step of
    ``steps`` restored onto the mesh by this rank, with the I/O witness
    counting the DFS bytes it reads. Returns, per step, the gathered
    params, this rank's bytes read at CRITICAL, the index's bytes, the
    plan's payload and planned bytes, and the bytes of this rank's
    slices; under "save", the most bytes of gathered leaves alive at once
    during the save, against the largest leaf and the whole tree."""
    import torch
    from _pytest.monkeypatch import MonkeyPatch
    from torch.distributed.tensor import DTensor

    import torch_io_witness
    from repro_torch.ckpt.checkpoint import Checkpointer, flat_with_names
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core.pipeline import CRITICAL, IOScheduler
    from repro_torch.dfs.hdfs import HdfsCluster
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import Model
    from repro_torch.models.sharded import shard_params
    from repro_torch.optim.adamw import tree_map

    cfg = reduced(get_config(arch), dtype="float32")
    model = Model(cfg, rules)
    ck = Checkpointer(HdfsCluster(root), **GEOMETRY)
    out = {}
    if params is not None:
        full = params_from_numpy(params, cfg, device="cpu",
                                 dtype=torch.float32)
        sharded = shard_params(full, rules, cfg)
        del full
        out["save"] = _save_peak(ck, sharded)
    patch = MonkeyPatch()
    witness = torch_io_witness.install(patch)
    try:
        for step in steps:
            like = model.init_like(dtype=torch.float32)
            _, plans = ck.plan_restore(step, like)
            index_bytes = len(ck.hdfs.read(ck.index_path(step)))
            witness.read.clear()
            (got,) = ck.restore_planned(step, like, sched=IOScheduler(),
                                        device=model.device)
            mine = sum(t.to_local().numel() * t.element_size()
                       for _, t in flat_with_names(got))
            out[step] = {
                "params": tree_map(lambda t: t.full_tensor().numpy(), got),
                "dtensors": all(isinstance(t, DTensor)
                                for _, t in flat_with_names(got)),
                "read": witness.read.get(CRITICAL, 0),
                "unslotted": witness.read.get(None, 0),
                "index_bytes": index_bytes,
                "payload": plans[0].payload_bytes,
                "planned": plans[0].planned_bytes,
                "mine": mine}
    finally:
        patch.undo()
    return out


def _save_peak(ck, tree) -> dict:
    """``ck.save(1, tree)`` of a DTensor tree, counting the bytes of the
    gathered leaves (``full_tensor``'s results) alive at once."""
    import weakref

    from _pytest.monkeypatch import MonkeyPatch
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.checkpoint import flat_with_names

    live = [0, 0]   # now, most
    gather = DTensor.full_tensor

    def counted(self, *a, **kw):
        t = gather(self, *a, **kw)
        n = t.numel() * t.element_size()
        live[0] += n
        live[1] = max(live[1], live[0])
        weakref.finalize(t, lambda: live.__setitem__(0, live[0] - n))
        return t

    patch = MonkeyPatch()
    patch.setattr(DTensor, "full_tensor", counted)
    try:
        ck.save(1, tree)
    finally:
        patch.undo()
    sizes = [t.numel() * t.element_size() for _, t in flat_with_names(tree)]
    return {"peak": live[1], "largest": max(sizes), "tree": sum(sizes)}
