"""The dry run: build every (architecture x input shape) step on the meta
device, count what it runs and price it on one H100; the counterpart of
the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each step on its production meshes
(16x16 and 2x16x16 TPU chips) and reads XLA's memory and cost analyses.
Here a step is built as ``chip_smoke.py`` and the launchers run it, on
parameters, optimizer state, caches and inputs of the meta device
(``Model.init_like``), and run there: nothing is computed or allocated, and
``roofline/step_cost.StepCount`` counts its FLOPs (by dtype), its bytes and
its live storages, whose peak is the step's memory on one card. The
kernels run as their operators' fake implementations, priced by their FLOP
formulas. By default the mesh is one card ("1").

``--multi-pod`` runs each pair on the 2x16x16 production mesh (512
devices), ``--both-meshes`` on 16x16 (256) and 2x16x16, as the reference
does; each mesh in a process of its own (``--mesh-worker``) whose default
group is a ``"fake"`` one of that many ranks, rank 0, every shard a
meta tensor. The model runs its sharded path (``Model(cfg, make_rules(mesh))``)
and the count sees rank 0's local work (``StepCount`` steps aside for
DTensor). Per device: FLOPs are the one-card count divided by the devices,
as the reference divides its analytic count; bytes and the peak of the
live storages are the rank's own; the collectives' bytes by kind are
those of the functional collectives DTensor issues (in place of the
reference's ``roofline/hlo.py``), priced at ``LINK_BW``.
``--moe-sharding``, ``--serving-layout``, ``--seq-sharded-acts``,
``--param-gather-dtype``, ``--ssd-compute-dtype``, ``--ssm-chunk`` and
``--no-remat`` are the reference's knobs (``sharding/rules.py``), taken
on one card and on the meshes and recorded in each result line, as the
reference records them. On the meta device the SSD operator's
bf16-intra instance is priced as the default one: the same least work,
the same bytes.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--tiny] [--out out.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--launch-profile PATH`` validates the live environment against a
recorded launch profile (``repro_torch.tune.launchprofile``) first: drift
prints as ``[launch-profile] drift`` lines, and ``--strict-launch-profile``
turns any drift into exit code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, get_tiny
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import frontend
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline.analysis import analyze, format_table
from repro_torch.roofline.step_cost import StepCount
from repro_torch.serve.step import make_decode_step, make_prefill
from repro_torch.sharding.rules import single_device_rules
from repro_torch.train.step import make_train_step

# long_500k needs sub-quadratic attention / bounded state: SSM, hybrid
# (windowed shared attention), and SWA archs run it; pure full-attention
# archs skip it (the reference's set)
LONG_OK = {"mamba2-370m", "zamba2-1.2b", "mixtral-8x22b"}
MESH, CHIPS = "1", 1
CARD_BYTES = 80e9  # one H100's device memory
# the production meshes: name -> (multi_pod, devices)
MESHES = {"16x16": (False, 256), "2x16x16": (True, 512)}
# the Rules fields the CLI sets (--no-remat sets remat)
KNOBS = ("moe_sharding", "serving_layout", "seq_sharded_acts",
         "param_gather_dtype", "ssd_compute_dtype", "ssm_chunk", "remat")


def combos():
    for arch in ARCHS:
        for shape_id in SHAPES:
            if shape_id == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, shape_id


def _inputs(cfg: ModelConfig, b: int, s: int, *, labels: bool) -> dict:
    """A step's batch on the meta device: tokens, or a frontend family's
    fp32 embeddings (with M-RoPE positions for qwen2-vl); labels for
    training."""
    meta = dict(device="meta")
    batch = {}
    if frontend.needs_embeddings(cfg):
        batch["embeddings"] = torch.empty(frontend.embedding_shape(cfg, b, s),
                                          dtype=torch.float32, **meta)
    else:
        batch["tokens"] = torch.empty((b, s), dtype=torch.int32, **meta)
    if cfg.mrope:
        batch["mrope_pos"] = torch.empty(frontend.mrope_pos_shape(cfg, b, s),
                                         dtype=torch.int32, **meta)
    if labels:
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, **meta)
    return batch


def build_step(model: Model, shape: ShapeConfig, *, tiny: bool = False,
               cache_len: int | None = None):
    """Returns (fn, args of meta tensors, step_kind), ``fn(*args)`` being
    the step: ``make_train_step`` with AdamW state over fp32 masters; a
    serving engine's ``make_prefill`` or one ``make_decode_step`` token
    (at the last position of a full cache), each handed the fp32
    unembedding table as the engine hands it. ``cache_len``: the ring's
    length, the shape's sequence length by default."""
    cfg = model.cfg
    b = shape.global_batch if not tiny else min(shape.global_batch, 4)
    s = shape.seq_len if not tiny else min(shape.seq_len, 256)

    if shape.kind == "train":
        params = model.init_like(dtype=getattr(torch, cfg.param_dtype))
        step = make_train_step(model, AdamWConfig())
        return step, (params, adamw_init(params),
                      _inputs(cfg, b, s, labels=True)), "train"

    params = model.init_like()
    unembed = model.unembed_table(params)
    cache_len = cache_len or s
    if shape.kind == "prefill":
        prefill = make_prefill(model, b, cache_len)
        return (lambda p, batch, u: prefill(p, batch, unembed=u),
                (params, _inputs(cfg, b, s, labels=False), unembed),
                "prefill")

    decode = make_decode_step(model, b, cache_len)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return (lambda p, t, c, u: decode(p, t, c, cache_len - 1, unembed=u),
            (params, tokens, model.init_cache(b, cache_len), unembed),
            "decode")


def run_one(arch: str, shape_id: str | None = None, *, tiny: bool = False,
            cfg: ModelConfig | None = None, shape: ShapeConfig | None = None,
            cache_len: int | None = None, knobs: dict | None = None,
            verbose: bool = True, tag: str = "") -> dict:
    """One dry run: ``arch``'s config (tiny, or ``cfg``) at ``shape_id``'s
    shape (or ``shape``) under the rules' ``knobs`` (``KNOBS``), as the
    reference's record on one card."""
    cfg = cfg or (get_tiny(arch) if tiny else get_config(arch))
    shape = shape or SHAPES[shape_id]
    model = Model(cfg, single_device_rules(**(knobs or {})), device="meta")

    t0 = time.perf_counter()
    fn, args, step_kind = build_step(model, shape, tiny=tiny,
                                     cache_len=cache_len)
    with StepCount(args) as count:
        fn(*args)
    t_trace = time.perf_counter() - t0

    ana = count.cost()
    mem = count.memory()
    cost = {"flops": ana["flops"], "flops_fp32": ana["flops_fp32"],
            "bytes accessed": ana["bytes"]}
    coll = {"total": 0}
    report = analyze(
        arch=arch, shape=shape, mesh_name=MESH, chips=CHIPS,
        step_kind=step_kind, cost=cost, collectives=coll, cfg=cfg,
        memory_per_device=mem["peak_memory_in_bytes"])
    out = {
        "arch": arch, "shape": shape.name, "mesh": MESH, "chips": CHIPS,
        "step_kind": step_kind, "tiny": tiny, "tag": tag,
        **{k: getattr(model.rules, k) for k in KNOBS},
        "remat": model.remat, "trace_s": round(t_trace, 2),
        "memory": mem,
        "cost": cost,
        "cost_analytic_global": ana,
        "collectives": coll,
        "roofline": report.to_json(),
    }
    if verbose:
        gb = mem["peak_memory_in_bytes"] / 1e9
        fits = "fits" if mem["peak_memory_in_bytes"] <= CARD_BYTES else \
            "does not fit"
        print(f"[dryrun] {arch:<20} {shape.name:<12} {MESH:<3} "
              f"{step_kind:<7} trace {t_trace:6.1f}s  peak {gb:9.2f} GB "
              f"({fits} 80 GB)  compute {report.compute_s:.4f}s  "
              f"memory {report.memory_s:.4f}s  -> {report.bottleneck} "
              "(H100 constants)", flush=True)
    return out


def run_sharded(arch: str, shape_id: str, mesh_name: str, *,
                tiny: bool = False, knobs: dict | None = None,
                verbose: bool = True, tag: str = "") -> dict:
    """One pair on a production mesh, in a process whose default group is
    a fake one of the mesh's size (``mesh_worker``): the step's count on
    rank 0's shards, FLOPs from the one-card count."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.rules import make_rules
    knobs = dict(knobs or {})
    multi_pod, chips = MESHES[mesh_name]
    cfg = get_tiny(arch) if tiny else get_config(arch)
    shape = SHAPES[shape_id]
    one = run_one(arch, shape_id, tiny=tiny, knobs=knobs,
                  verbose=False)["cost_analytic_global"]
    # the mesh's device type is the CPU's: DTensor's redistribution cost
    # model asks torch.<device type>.device_count(), which meta lacks; the
    # shards themselves are meta tensors
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model = Model(cfg, make_rules(mesh, **knobs), device="meta")
    t0 = time.perf_counter()
    fn, args, step_kind = build_step(model, shape, tiny=tiny)
    with StepCount(args) as count:
        fn(*args)
    t_trace = time.perf_counter() - t0
    local = count.cost()
    mem = count.memory()
    coll = count.collectives()
    cost = {"flops": one["flops"] / chips,
            "flops_fp32": one["flops_fp32"] / chips,
            "bytes accessed": local["bytes"]}
    report = analyze(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        step_kind=step_kind, cost=cost, collectives=coll, cfg=cfg,
        memory_per_device=mem["peak_memory_in_bytes"])
    out = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "step_kind": step_kind, "tiny": tiny, "tag": tag,
        **{k: getattr(model.rules, k) for k in KNOBS},
        "remat": model.remat, "trace_s": round(t_trace, 2),
        "memory": mem, "cost": cost,
        "cost_analytic_global": {k: v for k, v in one.items()
                                 if k != "by_op"},
        "cost_local": {k: v for k, v in local.items() if k != "by_op"},
        "collectives": coll,
        "roofline": report.to_json(),
    }
    if verbose:
        gb = mem["peak_memory_in_bytes"] / 1e9
        fits = "fits" if mem["peak_memory_in_bytes"] <= CARD_BYTES else \
            "does not fit"
        print(f"[dryrun] {arch:<20} {shape.name:<12} {mesh_name:<8} "
              f"{step_kind:<7} trace {t_trace:6.1f}s  peak {gb:9.2f} GB/dev "
              f"({fits} 80 GB)  coll {coll['total'] / 1e9:9.3f} GB  "
              f"compute {report.compute_s:.4f}s  memory "
              f"{report.memory_s:.4f}s  collective {report.collective_s:.4f}s"
              f"  -> {report.bottleneck} (H100 constants)", flush=True)
    return out


def mesh_worker(mesh_name: str, todo: list, *, tiny: bool, knobs: dict,
                tag: str, out_path: str) -> int:
    """The pairs on one production mesh, in this process, over a fake
    group of the mesh's size; one JSON line each into ``out_path`` (an
    ``{"error"}`` line for a pair that fails). Returns the failures."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=MESHES[mesh_name][1])
    failures = 0
    try:
        for arch, shape_id in todo:
            try:
                res = run_sharded(arch, shape_id, mesh_name, tiny=tiny,
                                  knobs=knobs, tag=tag)
            except Exception as e:  # noqa: BLE001 - report every pair
                traceback.print_exc()
                res = {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                       "error": repr(e)}
                failures += 1
            with open(out_path, "a") as f:
                f.write(json.dumps(res) + "\n")
    finally:
        dist.destroy_process_group()
    return failures


def run_meshes(todo: list, meshes: list, *, tiny: bool, knobs: dict,
               tag: str) -> list:
    """Each mesh's pairs in a child process (``--mesh-worker``); their
    records in order."""
    import subprocess
    import tempfile
    records = []
    for mesh_name in meshes:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh-worker", mesh_name, "--worker-out", out,
                   "--pairs", json.dumps(todo), "--tag", tag]
            if tiny:
                cmd.append("--tiny")
            subprocess.run(cmd + knob_args(knobs), check=False)
            if os.path.exists(out):
                with open(out) as f:
                    records += [json.loads(line) for line in f]
    return records


def knob_args(knobs: dict) -> list:
    """The CLI flags that set ``knobs`` (``KNOBS``' fields)."""
    out = []
    for k, v in knobs.items():
        if k == "remat":
            out += [] if v else ["--no-remat"]
            continue
        flag = "--" + k.replace("_", "-")
        out += [flag] if v is True else ([] if v is False else [flag, str(v)])
    return out


def check_launch_profile(path: str, *, environ=None) -> list:
    """Load a recorded launch profile from ``path`` and return the drift
    lines against ``environ`` (default: this process's environment).
    Accepts either a bare ``LaunchProfile.to_json()`` document or an
    env-cache snapshot meta that embeds one under ``"launch_profile"``."""
    from repro_torch.tune.launchprofile import profile_drift
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "launch_profile" in doc:
        doc = doc["launch_profile"]
    return profile_drift(doc, environ=os.environ if environ is None
                         else environ)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (512 devices)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="16x16 and 2x16x16")
    ap.add_argument("--moe-sharding", choices=["tp", "ep"], default="tp")
    ap.add_argument("--serving-layout", action="store_true")
    ap.add_argument("--seq-sharded-acts", action="store_true")
    ap.add_argument("--param-gather-dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--ssd-compute-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="the SSD scan's intra-chunk products (the card's "
                         "bf16-intra kernel instances)")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="the plain SSD scan's chunk (0: the config's)")
    ap.add_argument("--no-remat", action="store_true",
                    help="keep each layer's activations for the backward")
    ap.add_argument("--mesh-worker", choices=sorted(MESHES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    ap.add_argument("--pairs", help=argparse.SUPPRESS)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced configs/shapes (harness self-test)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--launch-profile", default="",
                    help="JSON launch profile (or env-cache meta) to "
                         "validate the live environment against")
    ap.add_argument("--strict-launch-profile", action="store_true",
                    help="exit 2 on any launch-profile drift")
    args = ap.parse_args(argv)

    knobs = {k: getattr(args, k) for k in KNOBS if k != "remat"}
    knobs["remat"] = not args.no_remat
    if args.mesh_worker:
        todo = [tuple(p) for p in json.loads(args.pairs)]
        raise SystemExit(1 if mesh_worker(
            args.mesh_worker, todo, tiny=args.tiny, knobs=knobs,
            tag=args.tag, out_path=args.worker_out) else 0)

    if args.launch_profile:
        drift = check_launch_profile(args.launch_profile)
        for line in drift:
            print(f"[launch-profile] drift: {line}", flush=True)
        if not drift:
            print("[launch-profile] ok: environment matches "
                  f"{args.launch_profile}", flush=True)
        elif args.strict_launch_profile:
            raise SystemExit(2)

    if args.all:
        todo = list(combos())
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    results, failures = [], []
    if args.multi_pod or args.both_meshes:
        meshes = (["16x16", "2x16x16"] if args.both_meshes
                  else ["2x16x16"])
        for res in run_meshes(todo, meshes, tiny=args.tiny, knobs=knobs,
                              tag=args.tag):
            if "error" in res:
                failures.append((res["arch"], res["shape"], res["mesh"],
                                 res["error"]))
                continue
            results.append(res)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
        got = {(r["arch"], r["shape"], r["mesh"]) for r in results}
        failures += [(a, s, m, "no record") for a, s in todo for m in meshes
                     if (a, s, m) not in got and not any(
                         f[:3] == (a, s, m) for f in failures)]
        todo = []
    for arch, shape_id in todo:
        try:
            res = run_one(arch, shape_id, tiny=args.tiny, knobs=knobs,
                          tag=args.tag)
            results.append(res)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
        except Exception as e:  # noqa: BLE001 - report every pair
            traceback.print_exc()
            failures.append((arch, shape_id, repr(e)))

    if results:
        from repro_torch.roofline.analysis import RooflineReport
        print(format_table([RooflineReport(**r["roofline"])
                            for r in results]))
    print(f"\n{len(results)} ok, {len(failures)} failed")
    for f in failures:
        print("FAILED:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
