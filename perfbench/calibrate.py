"""The readings that a cell's limits are set from, on the card, in one
process (not run by the benchmark's own runs):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--controls 3] [--out FILE]

For every seed, the program's sound run (set-up and, for restarts, one
restart: the readings that a run compares) against the float32 reference:
the lower readings. For the first ``--controls`` seeds, the control (the
reference with every matrix product's operands in scaled float8 e4m3, put
in the program's place) and the planted fault of half the batch left out
(the mean over the rest), each against the same float32 reference, and
for every seed the reference with each step's loss altered by 1%: the
upper readings. A step that returns its state unchanged reads 1 in
``update_gap`` by the measure and needs no run. Prints one JSON line a
reading and writes them all to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import check, harness
    from perfbench.reference.common import Precision
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness.spec()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.load_json("configs", f"{cell['config']}.json")
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    kind = harness.kind_module(traffic["kind"])
    rows = []
    for i, seed in enumerate(args.seeds):
        job = kind.Job(harness.Run(cell, cfg, traffic, seed))
        try:
            t0 = time.perf_counter()
            job.setup()
            if traffic["kind"] == "resume":
                job.resume(keep=True)
            program = job.readings()
            job.free()
            t1 = time.perf_counter()
            ref = job.reference()
            t2 = time.perf_counter()
            sides = {"sound": program}
            if i < args.controls:
                sides["fp8_control"] = job.reference(prec=Precision("fp8"))
                sides["half_batch"] = job.reference(half_batch=True)
            # an answer altered where it is produced: each loss by 1%
            sides["loss_altered"] = dict(
                ref, losses=[x * 1.01 for x in ref["losses"]])
            readings = {}
            for what, side in sides.items():
                readings[what] = dict(check.numbers(side, ref), worst={
                    key: check.worst_leaves(side, ref, key)
                    for key in check.LEAF_NUMBERS if key in side},
                    losses=side["losses"])
        finally:
            job.close()
        for what, nums in readings.items():
            row = {"workload": args.workload, "seed": seed, "what": what,
                   **nums}
            if what == "sound":
                row.update(program_s=t1 - t0, reference_s=t2 - t1,
                           reference_losses=ref["losses"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
