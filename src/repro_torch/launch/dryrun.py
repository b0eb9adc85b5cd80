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
formulas. The mesh is one card ("1"); the production meshes need
sharding (ROADMAP A.7), so ``--multi-pod`` and ``--both-meshes`` refuse.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--tiny] [--out out.jsonl]

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
from repro_torch.train.step import make_train_step

# long_500k needs sub-quadratic attention / bounded state: SSM, hybrid
# (windowed shared attention), and SWA archs run it; pure full-attention
# archs skip it (the reference's set)
LONG_OK = {"mamba2-370m", "zamba2-1.2b", "mixtral-8x22b"}
MESH, CHIPS = "1", 1
CARD_BYTES = 80e9  # one H100's device memory
SHARDING = ("the production meshes (16x16, 2x16x16) need sharding, which "
            "the port does not have yet (ROADMAP A.7); the dry run prices "
            "one card (mesh \"1\")")


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
            cache_len: int | None = None, verbose: bool = True,
            tag: str = "") -> dict:
    """One dry run: ``arch``'s config (tiny, or ``cfg``) at ``shape_id``'s
    shape (or ``shape``), as the reference's record on one card."""
    cfg = cfg or (get_tiny(arch) if tiny else get_config(arch))
    shape = shape or SHAPES[shape_id]
    model = Model(cfg, device="meta")

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
                    help="refused: needs sharding (ROADMAP A.7)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="refused: needs sharding (ROADMAP A.7)")
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

    if args.multi_pod or args.both_meshes:
        print(f"dryrun: {SHARDING}", file=sys.stderr)
        raise SystemExit(2)

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
    for arch, shape_id in todo:
        try:
            res = run_one(arch, shape_id, tiny=args.tiny, tag=args.tag)
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
