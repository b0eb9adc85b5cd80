#!/usr/bin/env python3
"""Times the main paths of one or more checkouts, each in a fresh process,
on a machine with one card, in the order given (for a change against its
parent: parent, tree, tree, parent):

    python3 scripts/time_paths.py build/parent . . build/parent

Each checkout builds its kernel library and times, on the host's clock
around work that ends in a synchronize, so that host costs count: the
prefill of qwen2.5-3b and of mamba2-370m at full width (B = 8, S = 1024,
a ring of 2048; 10 calls after 2), and a training step of each at full
width (qwen2.5-3b at B = 2, mamba2-370m at B = 8, S = 2048, AdamW over
fp32 masters; 6 steps after 2), and prints the medians and the kernels'
launches per call. The last line gives each path's medians by checkout.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(sys.argv[1]) / "src"))
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.ssd import ssd_chunked_bwd_kernel, ssd_chunked_kernel
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

build.build()
out = {}
wrappers = (flash_attention, flash_attention_bwd, ssd_chunked_kernel,
            ssd_chunked_bwd_kernel)


def timed(name, fn, warmup, runs):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out[name] = [statistics.median(times), [w.launches for w in wrappers]]


for arch in ("qwen2.5-3b", "mamba2-370m"):
    cfg = get_config(arch)
    m = Model(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    unembed = m.unembed_table(params)
    toks = torch.randint(0, cfg.vocab_size, (8, 1024), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        timed(f"prefill {arch}", lambda: m.prefill(
            params, {"tokens": toks}, cache_len=2048, unembed=unembed), 2, 10)
    del params, unembed
    torch.cuda.empty_cache()

for arch, b in (("qwen2.5-3b", 2), ("mamba2-370m", 8)):
    cfg = get_config(arch)
    m = Model(cfg, device="cuda")
    state = init_train_state(m, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (b, 2049), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(m, AdamWConfig())
    timed(f"train {arch}", lambda: step(state.params, state.opt, batch), 2, 6)
    del state, step
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(trees: list[str]) -> int:
    by_path: dict = {}
    for tree in trees:
        run = subprocess.run([sys.executable, "-c", CHILD,
                              str(Path(tree).resolve())],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        result = json.loads(run.stdout.strip().splitlines()[-1])
        for name, (ms, launches) in result.items():
            print(f"{tree}: {name}: median {ms:.2f} ms, launches (flash, "
                  f"flash_bwd, ssd, ssd_bwd) {launches}", flush=True)
            by_path.setdefault(name, []).append(f"{tree} {ms:.2f}")
    for name, runs in by_path.items():
        print(f"{name}: {', '.join(runs)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
