#!/usr/bin/env python3
"""Times the SSD backward at mamba2-370m's training shape (B = 8, S = 2048,
H = 32, P = 64, G = 1, N = 128, the model's dt/A draws) without checking
its output, on the card: a design variant's cost, or how much of the time
a part of the kernels takes when a copy leaves it out.

    python3 scripts/time_ssd_bwd.py [CHECKOUT ...]

Each CHECKOUT (default: this repository) is a directory holding src/ and
chip_smoke.py, such as a copy made by scripts/chip_variants.sh; each is
built and timed in a process of its own. Prints per checkout the mean time
of 20 calls and torch.profiler's device time per launch of one call, with
the card's name and power limit.
"""

import sys

from time_flash_bwd import main

ONE = """
import sys
sys.path.insert(0, "src")
import torch
import chip_smoke as c
from repro_torch.kernels.ssd import ssd_chunked_bwd_kernel
card = c.phase_device()
gen = torch.Generator(device="cuda").manual_seed(2)
_, b, s, h, p, g, n = c.SSD_BWD_CASES[0]
args = c.ssd_train_inputs(gen, b, s, h, p, g, n)
dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
ms = c.cuda_ms(lambda: ssd_chunked_bwd_kernel(*args, dy), iters=20)
print(f"ssd_bwd train: {ms:.4f} ms on {card}", flush=True)
c.profile_window("ssd_bwd train", lambda: ssd_chunked_bwd_kernel(*args, dy), card,
                 share_of="ssd_bwd")
"""


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ONE))
