"""Runs one cell of the benchmark once, on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line on standard output is the
result; the numbers that decided ``correct`` are the last lines on
standard error. Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits 2. The program's build and kernel caches are
kept under ``build/`` in the checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench-cache"


def main(argv=None) -> int:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from perfbench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace),
                                  age0=harness.process_age() - (
                                      time.perf_counter() - T0),
                                  t0=T0)
    except harness.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
