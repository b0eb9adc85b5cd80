#!/usr/bin/env python3
"""Times the flash backward, its fast and its deterministic path, at the
training shape (B = 2, S = 2048, Hq = 16, Hkv = 2, D = 128, causal) without
checking its output, on the card: a design variant's cost, or how much of
the time a part of the kernels takes when a copy leaves it out.

    python3 scripts/time_flash_bwd.py [CHECKOUT ...]

Each CHECKOUT (default: this repository) is a directory holding src/ and
chip_smoke.py, such as a copy made by scripts/chip_variants.sh; each is
built and timed in a process of its own. Prints per checkout the mean time
of 20 calls of each path and torch.profiler's device time per kernel of
one call of each, with the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

ONE = """
import sys
sys.path.insert(0, "src")
import torch
import chip_smoke as c
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_deterministic)
card = c.phase_device()
gen = torch.Generator(device="cuda").manual_seed(1)
q, k, v, do = (torch.randn((c.TRAIN_BATCH, c.TRAIN_SEQ, h, 128), generator=gen,
                           device="cuda", dtype=torch.bfloat16) for h in (16, 2, 2, 16))
_, lse = flash_attention(q, k, v, return_lse=True)
for fn in (flash_attention_bwd, flash_attention_bwd_deterministic):
    ms = c.cuda_ms(lambda: fn(q, k, v, lse, do), iters=20)
    print(f"{fn.__name__} train: {ms:.4f} ms on {card}", flush=True)
    c.profile_window(f"{fn.__name__} train", lambda: fn(q, k, v, lse, do), card,
                     share_of="flash_bwd")
"""


def main(argv: list[str], one: str = ONE) -> int:
    """Runs the script ``one`` in a process of its own in each checkout of
    ``argv`` (default: this repository); the first non-zero exit code."""
    roots = [Path(a) for a in argv] or [Path(__file__).resolve().parents[1]]
    rc = 0
    for root in roots:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", one], cwd=root, timeout=600)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
