#!/usr/bin/env python3
"""Where a training step's device memory peaks, on the plain path and on
the sharded path on a one-device NCCL mesh (1, 1), at chip_smoke.py's
[shard] training cell (qwen2.5-3b, B = 2 x S = 2048, fp32 masters, AdamW),
from the caching allocator's trace, on a machine with one card:

    python3 scripts/shard_peak.py [--top 12]

For each path it records the first step
(``torch.cuda.memory._record_memory_history``), replays the trace to the
moment the allocated bytes peak, and prints the peak, the bytes allocated
before the step (masters, AdamW state, the batch), and the step's blocks
alive at the peak, grouped by the innermost frame of this repository that
allocated them (blocks the autograd engine allocates have no Python frame;
they are grouped by size, named where the size is one of the cell's
tensors'). It ends with the groups whose bytes differ between the paths,
and the card's name and power limit.
"""

import argparse
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as c  # noqa: E402


def _where(frames: list) -> str:
    """The innermost frame in this repository's sources, as path:line."""
    for f in frames:
        name = f.get("filename", "")
        if "/repro_torch/" in name or name.endswith("chip_smoke.py"):
            rel = name.split("/src/", 1)[-1]
            return f"{rel}:{f.get('line')} ({f.get('name')})"
    return ""


def _sizes(cfg) -> dict:
    """Bytes of the cell's large tensors, by name."""
    b, s, v, d = c.TRAIN_BATCH, c.TRAIN_SEQ, cfg.vocab_size, cfg.d_model
    return {b * s * v * 4: "fp32 logits [B, S, V]",
            b * s * v * 2: "bf16 [B, S, V]",
            v * d * 4: "fp32 [V, d] (embed / its gradient)",
            v * d * 2: "bf16 [V, d] (the table in use)"}


def peak_blocks(snapshot: dict) -> tuple[int, dict]:
    """Replays the trace: (the most bytes the step held at once, {address:
    (size, where)} of the step's blocks alive then)."""
    live, now, most, at_most = {}, 0, 0, {}
    for event in snapshot["device_traces"][0]:
        action = event["action"]
        if action == "alloc":
            live[event["addr"]] = (event["size"], _where(event["frames"]))
            now += event["size"]
            if now > most:
                most, at_most = now, dict(live)
        elif action == "free_completed" and event["addr"] in live:
            now -= live.pop(event["addr"])[0]
    return most, at_most


def record_step(name: str, model, plain, cfg):
    """The first AdamW step of ``model`` from seed-0 masters, recorded:
    (bytes before it, the allocator's peak, the trace's peak blocks)."""
    import torch
    from repro_torch.data.loader import Loader, ShardedLoader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models.sharded import shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    c.free_card()
    params = plain.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    stream = SyntheticStream(cfg.vocab_size, 0)
    if name == "sharded":
        params = shard_params(params, model.rules, cfg)
        loader = ShardedLoader(stream, model.rules, c.TRAIN_BATCH,
                               c.TRAIN_SEQ)
    else:
        loader = Loader(stream, c.TRAIN_BATCH, c.TRAIN_SEQ, "cuda")
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=c.TRAIN_LR))
    batch = loader(0)
    c.free_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batch
    return before, peak, peak_blocks(snapshot)


def groups(blocks: dict, sizes: dict) -> dict:
    """{group: bytes}: by frame, or for frameless blocks by size."""
    out = defaultdict(int)
    for size, where in blocks.values():
        if not where:
            where = f"autograd engine, {sizes.get(size, f'{size} B')} blocks"
        out[where] += size
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    card = c.phase_device()
    c.phase_build()
    store = ROOT / "build" / "shard-peak-store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg, plain, sharded = c._shard_model(c.QWEN, mesh)
        sizes = _sizes(cfg)
        seen = {}
        for name, model in (("plain", plain), ("sharded", sharded)):
            before, peak, (most, blocks) = record_step(name, model, plain,
                                                       cfg)
            seen[name] = groups(blocks, sizes)
            print(f"{name}: peak {peak / 1e9:.3f} GB = {before / 1e9:.3f} GB "
                  f"before the step + {most / 1e9:.3f} GB of the step's "
                  f"blocks alive at the trace's peak "
                  f"({(before + most) / 1e9:.3f} GB), on {card}", flush=True)
            for where, n in sorted(seen[name].items(),
                                   key=lambda kv: -kv[1])[:args.top]:
                print(f"  {n / 1e9:8.3f} GB  {where}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    print("groups whose bytes at the peak differ (plain - sharded):")
    keys = set(seen["plain"]) | set(seen["sharded"])
    diff = {k: seen["plain"].get(k, 0) - seen["sharded"].get(k, 0)
            for k in keys}
    for where, n in sorted(diff.items(), key=lambda kv: -abs(kv[1])):
        if abs(n) >= 1e8:
            print(f"  {n / 1e9:+8.3f} GB  {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
