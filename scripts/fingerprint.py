#!/usr/bin/env python3
"""Fingerprints the main paths' results of one or more checkouts, each in
a fresh process, on a machine with one card, and compares them:

    python3 scripts/fingerprint.py build/parent . . build/parent

Each checkout builds its kernel library, makes the same models from seed
0 and runs, under torch.use_deterministic_algorithms(True): a prefill (B =
4, S = 512, a ring of 1024) and two decode steps of qwen2.5-3b,
mamba2-370m and zamba2-1.2b at full width, qwen2-vl-72b at full width cut
to 2 layers from stand-in embeddings with vision-grid M-RoPE positions;
one training step of qwen2.5-3b cut to 4 layers and of mamba2-370m cut to
8 (B = 1, S = 512, AdamW over fp32 masters). It prints a SHA-256 of the
bits of every logit, cache, loss and updated parameter, and each kernel's
launches. The script exits 1 unless every checkout prints the same: two
checkouts that differ only in how the kernels are reached give the same
bits (a change that moves a result by one ulp shows).
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import dataclasses, hashlib, json, os, sys
from pathlib import Path
sys.path.insert(0, str(Path(sys.argv[1]) / "src"))
# cuBLAS is deterministic only with this workspace setting
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.use_deterministic_algorithms(True)
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
from repro_torch.kernels.ssd import ssd_chunked_bwd_kernel, ssd_chunked_kernel
from repro_torch.models import frontend
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step

build.build()
out = {}
wrappers = (flash_attention, flash_attention_bwd,
            flash_attention_bwd_deterministic, ssd_chunked_kernel,
            ssd_chunked_bwd_kernel)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy())
    return h.hexdigest()[:16]


def serve(arch, layers=None, embeddings=False):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    m = Model(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s = 4, 512
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    batch = {"tokens": toks}
    if embeddings:
        batch = {"embeddings": frontend.fake_embeddings(cfg, b, s, gen,
                                                        "cuda")}
        if cfg.mrope:
            t = torch.arange(s, device="cuda")
            grid = torch.stack([t % 2, t % 16, t % 7], -1)
            batch["mrope_pos"] = (t[:, None] + grid).to(torch.int32).expand(
                b, s, 3)
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        logits, caches = m.prefill(params, batch, cache_len=1024)
        res = [logits, *caches.values()]
        nxt = logits.argmax(-1, keepdim=True)
        for i in range(2):
            logits, caches = m.decode_step(params, nxt, caches, s + i)
            res.append(logits)
            nxt = logits.argmax(-1, keepdim=True)
        res += list(caches.values())
    out[f"serve {arch}"] = [digest(*res),
                            [w.launches for w in wrappers]]
    del m, params, caches


def train(arch, layers):
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    m = Model(cfg, device="cuda")
    state = init_train_state(m, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 513), generator=gen,
                         device="cuda")
    for w in wrappers:
        w.launches = 0
    params, opt, metrics = make_train_step(m, AdamWConfig())(
        state.params, state.opt, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]})
    out[f"train {arch}"] = [digest(metrics["loss"], metrics["grad_norm"],
                                   *tree_leaves(params),
                                   *tree_leaves(opt)),
                            [w.launches for w in wrappers]]


serve("qwen2.5-3b")
serve("mamba2-370m")
serve("zamba2-1.2b")
serve("qwen2-vl-72b", layers=2, embeddings=True)
torch.cuda.empty_cache()
train("qwen2.5-3b", 4)
train("mamba2-370m", 8)
print(json.dumps(out))
"""


def main(trees: list[str]) -> int:
    seen = []
    for tree in trees:
        run = subprocess.run([sys.executable, "-c", CHILD,
                              str(Path(tree).resolve())],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        result = json.loads(run.stdout.strip().splitlines()[-1])
        seen.append(result)
        for name, (digest, launches) in result.items():
            print(f"{tree}: {name}: {digest} launches (flash, flash_bwd, "
                  f"flash_bwd_det, ssd, ssd_bwd) {launches}", flush=True)
    same = all(r == seen[0] for r in seen)
    print(f"all {len(trees)} runs give the same bits: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
