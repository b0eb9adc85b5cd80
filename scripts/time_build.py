#!/usr/bin/env python3
"""Times a cold build of the kernel library of one or more checkouts, one
after the other, each in a fresh process and a fresh directory, on a
machine with nvcc:

    python3 scripts/time_build.py build/parent . . build/parent

Prints, for each checkout in the order given, the seconds
``repro_torch.kernels.build.compile_into`` took (every source's nvcc
started together, then the link) and the library's size. Comparing a
commit with its parent this way (parent, tree, tree, parent) gives the
cold build's cost of a change to the kernels' sources, which a cold boot
pays inside env.install.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

CHILD = """
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(sys.argv[1]) / "src"))
from repro_torch.kernels import build
t0 = time.perf_counter()
lib = build.compile_into(sys.argv[2])
print(f"{time.perf_counter() - t0:.2f} s, {lib.stat().st_size} bytes")
"""


def main(trees: list[str]) -> int:
    for tree in trees:
        with tempfile.TemporaryDirectory() as out:
            run = subprocess.run([sys.executable, "-c", CHILD,
                                  str(Path(tree).resolve()), out],
                                 capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        print(f"[time_build] {tree}: cold build {run.stdout.strip()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
