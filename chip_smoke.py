#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:
  1. device: versions, the card's name and power limit; TF32 off.
  2. build: every CUDA kernel from src/repro_torch/csrc, with ptxas's
     register and shared-memory report.
  3. kernels: each kernel (flash attention, the SSD scan) against its plain
     PyTorch version at the serving paths' shapes and their edges (and
     zamba2-1.2b's: the flash kernels at 32 heads of 64 with a window of
     4096, the SSD at 64 heads with N = 64; moonshot-v1-16b-a3b's: the
     flash kernels at 16 heads of 128, MHA; musicgen-large's: 32 heads of
     64, MHA, no window; qwen2-vl-72b's: 64 / 8 heads of 128), then its
     time (at each
     model's shape) and achieved TFLOP/s beside the plain version's time, the
     library call's (SDPA; none for SSD) and its bound on the card; for the
     flash backward also the difference between two calls on the same
     inputs (its sums across blocks are atomic) and its kernels' device
     times from torch.profiler; its deterministic path too, bit-equal
     across two calls. The SSD backward: all six gradients against
     autograd of the plain version at the training shape and its edges,
     two calls bit-equal, its workspace, time and bound.
     unembed_ce: the training loss's vocab-chunked operator at
     UNEMBED_CE_CASES (mamba2-370m's benchmark cell, 16 x 2048 rows over
     1024 x 50,432, and its phase 7 batch; a tied table at qwen2.5-3b's
     training shape; fp32 operands): its fold and gradient kernels against their plain versions
     on the case's chunks, the operator's loss, dh and dW against its plain
     version by the row gates, one launch of each kernel per chunk, and
     the peak it adds no more than its backward workspace and the two
     gradients (the buffers a count of the step sees); at the cell's
     shape each kernel's time on one chunk beside its plain version's,
     logsumexp's and its bound, the chunk's three products, and the
     operator's forward + backward beside its bound, its plain version and
     the fp32 composition it replaced, with the peak each adds.
     ssd knobs: the SSD kernels' bf16-intra instances, the card's
     Rules(ssd_compute_dtype="bfloat16"): ptxas of each (no spill), the
     forward at the serving prefill's shapes and the backward at the
     training shapes against the plain fp32 version within 1.5x the plain
     bf16 version's own error (SSD_KNOB_BUDGET), apart from the default
     instance, the backward two calls bit-equal; their times in turns
     with the default's. After phase 7, mamba2-370m at full width under
     the knob: a prefill and the first step's gradients held to the
     default path's within the phase's budget, 3 steps; the launches the
     default path's, on the bf16-intra instances.
     moe: moonshot-v1-16b-a3b's MoE block (PyTorch, no kernel of its own)
     at its training shape: two forward + backward calls bit-equal under
     deterministic algorithms; its time and its scopes' split.
     tune kernels: every compiled launch config of the two forward kernels
     (flash: (128, 64), the default, and (64, 64) at D = 64 and 128,
     (128, 128) at D = 64; the SSD: tiles of 32, the default, and 16) at
     the main paths' forward shapes (TUNE_FLASH_SHAPES, TUNE_SSD_SHAPES),
     each held to its plain version by the row gates above, then timed
     beside its bound, ptxas's registers and spills (a spill fails), its
     shared memory, the roofline's predicted rank and, for flash, SDPA.
     tune boot: two boots of a one-node job through
     BootseerRuntime(tune=True) with those shapes as its tune workloads:
     the cold boot sweeps the compiled configs on the card and publishes
     the profile, the warm one fetches the same digest with 0 sweeps; the
     winners beside the defaults. musicgen-large and zamba2-1.2b then
     prefill under the profile in phase 5, held to their default-config
     prefill, and musicgen-large trains under it in phase 7.
  4. reference: tiny qwen2.5-3b, mamba2-370m, zamba2-1.2b (five layers:
     three calls of its shared block, whose window of 64 the prompts of
     100 pass), moonshot-v1-16b-a3b, musicgen-large, qwen2-vl-72b and
     mixtral-8x22b (4 experts, top 2) in bf16 on the card against the
     plain CPU path (the frontend families prefill from stand-in
     embeddings, qwen2-vl with vision-grid M-RoPE positions, then decode
     four tokens); for the MoE ones the
     routing decisions first: a token may take other experts on the card
     only at a near-tie (FLIP_MARGIN), and its rows leave the row gate.
  5. serve, once per model: qwen2.5-3b (36 layers), mamba2-370m (48
     layers), zamba2-1.2b (38 Mamba2 layers, 7 shared-block calls),
     moonshot-v1-16b-a3b (48 layers, 64 experts, top 6), musicgen-large
     (48 layers) and qwen2-vl-72b (32 of its 80 layers: SERVE_LAYERS), at
     full width, bf16, random weights from a seed (Model.init's peak
     within 1 GB of the tree), each answer 8 requests of token prompts
     through ServeEngine; the kernels'
     launch counts prove the prefill ran through its kernels (a flash
     launch per attention call, an SSD launch per Mamba2 layer, nothing
     else); the MoE model's dropped assignments are counted; prefill(S)
     is held against prefill(S-1) + decode_step (for the MoE model at a
     capacity factor that drops nothing); torch.profiler splits one
     prefill and four decode steps into device busy and idle time, and
     the MoE block into its scopes. qwen2-vl-72b also prefills from its
     tokens' embeddings with text-like M-RoPE positions, bit-equal to the
     prefill from the tokens, and from stand-in embeddings with
     vision-grid positions, then decodes four tokens.
  6. reference train: one AdamW step of each tiny model of phase 4 (bf16
     over fp32 masters) on the card against the plain CPU path: loss,
     gradient norm and every gradient leaf (the MoE ones with the card
     routed as the CPU was, after their routing is compared; the frontend
     families from stand-in embeddings, their embed leaf's gradient
     exactly zero on both devices).
  7. train: qwen2.5-3b at full width (fp32 masters, bf16 compute, remat)
     takes 8 AdamW steps on the synthetic stream at B = 2, S = 2048; the
     loss must fall, every step must launch the forward flash kernel 72
     times (36 layers, forward and recompute) and the backward 36 times,
     and peak memory stay under 80 GB; step time, tokens/s, model FLOPs
     utilisation and a torch.profiler split of one step. Then mamba2-370m
     the same way at B = 8, S = 2048: 96 SSD forward launches a step (48
     layers, forward and recompute) and 48 backward, no flash launch. Then
     zamba2-1.2b at B = 8, S = 2048: 14 flash forward and 7 backward, 76
     SSD forward and 38 backward launches a step; its MFU counts the
     shared block once per call. Then moonshot-v1-16b-a3b at full width,
     5 of its 48 layers (TRAIN_LAYERS), B = 2, S = 2048: 10 flash forward
     and 5 backward launches a step, peak under 80 GB; its MFU counts the
     k active experts. Then musicgen-large at full width, B = 8, S = 2048,
     and qwen2-vl-72b at full width, 1 of its 80 layers (TRAIN_LAYERS), B
     = 2, S = 2048, both on stand-in embeddings (qwen2-vl with vision-grid
     M-RoPE positions) and the stream's labels: 96 / 48 and 2 / 1 flash
     launches a step, and the flash backward's share of musicgen's step.
     Every trained model's step also launches the loss's fold and
     gradient kernels once per vocabulary chunk (loss_launches).
     roofline, in phases 5 and 7: each served model's prefill (a frontend
     family's from stand-in embeddings) and one decode step, and each
     trained model's step, counted on the card (roofline/step_cost.py:
     FLOPs by dtype, bytes) beside the dry run of the same config and
     shape on the meta device (launch/dryrun.py), priced at the H100's
     peaks; the roofline's share of the profiled wall and device-busy
     time; the dry run's peak memory beside the card's. It fails if the
     two counts differ in FLOPs, if the compute term exceeds the measured
     device-busy time, or if a training step's or a prefill's dry-run
     peak lies outside 0.85-1.15x the measured one.
  shard: the flash kernels on sequence shards at full width (qwen2.5-3b's
     training shape, B = 2, S = 2048, 16/2 heads of 128, and zamba2-1.2b's,
     B = 8, 32/32 heads of 64, window 4096): q cut into 4 pieces at
     q_offset 0, 512, 1024, 1536 against the whole K/V, forward with the
     LSE and backward; each piece's o, LSE and dQ and the summed dK/dV held
     to the plain versions by the row gates, the pieces' forward rows
     against the unsharded call's bits, the deterministic backward two
     calls bit-equal. Then the sharded path (Model(cfg, make_rules(mesh)):
     DTensors, local_map islands) on a one-device NCCL DeviceMesh (1, 1)
     at full width against the plain path on the same weights:
     qwen2.5-3b's prefill, 4 decodes (both fed the plain path's greedy
     tokens) and 8 requests through ServeEngine, and 8 training steps (B =
     2 x S = 2048); mamba2-370m's prefill and decodes; moonshot's at 5 of
     48 layers (the tp MoE island). Prefill logits and decodes by the row
     gates, greedy tokens equal, the first step's gradient leaves by the
     [train] row gate, losses within the [train] gate, launches
     equal to the plain path's and to one flash launch per attention call
     and one SSD launch per Mamba2 layer; bit-equality printed; prefill
     ms, decode ms a step, step ms and peak GB beside the plain path's
     (DTensor's host cost). The group is destroyed before resume and boot.
  8. resume, with no tuning profile active and under
     torch.use_deterministic_algorithms(True): qwen2.5-3b at
     full width trains 6 steps (run A), then anew 3 steps, saves a striped
     checkpoint of params and AdamW state (40.84 GB) into build/, frees the
     card and resumes a fresh model from it for 3 more (run B); every
     loss, and every leaf of params and optimizer state by an exact
     fingerprint of its bits, must be equal between A and B. Prints the
     save and restore rates and the time to first step after resume; then
     ServeEngine.from_checkpoint serves the checkpoint's params, whose
     prefill logits must be bit-equal to an engine's built from the saved
     tensors directly, and the time to first token from the cold restore.
  9. boot: the port's launchers as fresh processes, each booting through
     the BootSeer runtime: qwen2.5-3b training at full width cold (image
     record, nvcc builds the kernel library inside env.install, 2 steps,
     a 40.77 GB checkpoint) and warm (hot-block prefetch, the library
     restored from the env cache, byte-identical, no nvcc; resume, one
     step of 72 forward and 36 backward flash launches and the loss's
     kernels once per vocabulary chunk), then mamba2-370m
     serving cold and warm (48 SSD launches per prefill, the same greedy
     tokens). Prints each runtime stage, the critical path, the bytes the
     I/O scheduler read at CRITICAL and DEFERRED, and the wall time from
     the launch to the first step or the first token; and, against a
     fresh process that resumes the same checkpoint without the runtime,
     what the runtime's own reads of the checkpoint cost the warm boot.
  witness: in the same training workdir, one more warm boot of
     qwen2.5-3b at full width taking one step, in a fresh process under
     the port's lock witness and I/O witness (python -m
     repro_torch.analysis.witness, installed before anything of the port
     is imported; not timed): the locks witnessed, the observed lock-order
     edges and cycles against the port's static lint graph, the DFS bytes
     by priority, bytes moved that accounting missed, priority inversions
     and the kernels' launches. Any cycle, unaccounted byte or inversion,
     or a step without its 72 / 36 flash launches, fails.
The line before the last lists the kernels as JSON (the forward kernels
with their launches on the main path by launch config); the last line is
the result as JSON. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with this workspace setting, read at its
# first call: the resume phase runs under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) and the
# kernels' bounds: one source with the autotuner's pruning
from repro_torch.roofline.analysis import (  # noqa: E402
    PEAK_FLOPS as PEAK_BF16_FLOPS, PEAK_FP32_FLOPS)
from repro_torch.roofline.kernel_cost import (  # noqa: E402
    attention_bound, attention_bwd_bound, attention_flops, ssd_bound,
    ssd_bwd_bound, ssd_bwd_flops, ssd_flops, unmasked_pairs)

# A kernel against its plain version in bf16: the largest relative L2
# error of one output row (kernels/ref.py::row_rel_err; an absolute limit
# cannot judge rows whose values range from ~1 to ~0.03). Both sides round
# the output to bf16 (2^-8 relative at most) and the kernel also rounds P
# to bf16 before P @ V, so a sound row errs by a few 1e-3; one wrong key
# among a row's n shifts it by ~1/sqrt(n) of its size, 3e-2 at n = 1024.
KERNEL_ROW_RTOL = 2e-2
# tiny qwen2.5-3b in bf16 on the card against the plain path on the CPU:
# largest relative L2 error of one row of logits. On the CPU the bf16 model
# differs from the same weights in fp32 by <= 7.2e-3 so measured; two bf16
# paths that round in another order differ by about as much, and a wrong
# position, mask or cache slot by a sizeable fraction of 1.
REFERENCE_ROW_RTOL = 3e-2
# prefill(S) against prefill(S-1) + decode_step, relative L2 error of the
# fp32 logits: the two paths round differently in each of 36 bf16 layers
# (2^-8 per rounding; bf16 P in the kernel, fp32 in decode attention); a
# wrong position, mask or cache slot gives an error of order 1.
CONSISTENCY_RTOL = 5e-2
# The SSD kernel against its plain version (the chunked scan at the
# model's chunk of 256): y by the worst row over P, the final state by the
# worst row over N. Both start from the same bf16 inputs; the kernel runs
# its products on bf16 tensor cores with every fp32 operand split into a
# bf16 hi and lo part (~2^-16 relative per term, csrc/ssd.cu's error
# budget), in tiles of 32 instead of chunks of 256. y is then rounded to
# bf16 on both sides (2^-9 relative per element), so a sound row of y errs
# by ~3e-3 at most, and the fp32 state by ~3e-5. A dropped term, a
# position past S, a diagonal off by one or a lost lo part moves whole rows
# by a sizeable fraction of their size or the state past 1e-3.
SSD_Y_ROW_RTOL = 1e-2
SSD_STATE_ROW_RTOL = 1e-3

# The flash backward against its plain version (autograd of the fp32
# reference from the same bf16 inputs): dQ, dK, dV by the worst row's
# relative L2 error, each row's norm raised to at least GRAD_ROW_FLOOR of
# the median row norm (row 0 of dQ is exactly 0 under a causal mask, and
# any rounding of dP - delta is infinitely many times it). The kernel
# rounds P and dS to bf16 before their products (2^-9 relative per term,
# summed with cancellation in dS) and the outputs to bf16 (2^-9), and sums
# delta = rowsum(P o dP) in fp32, so the forward's 2e-2 holds with room: a
# sound kernel errs ~4e-3. SDPA's backward, printed beside it as the
# calibration, takes delta from its bf16 output and errs up to ~0.2 on the
# rows of dQ that cancel (a causal head's row 1, with two keys).
GRAD_ROW_RTOL = 2e-2
GRAD_ROW_FLOOR = 1e-2
# The forward's LSE against the plain logsumexp, absolute: an error e in a
# row's LSE scales that row's P by exp(-e), so 1e-3 admits a 0.1% error in
# P; both sides sum exact products of the same bf16 inputs in fp32.
LSE_ABS_TOL = 1e-3

# One train step of tiny qwen2.5-3b, card against the CPU's plain path,
# both bf16 over the same fp32 masters: each gradient leaf by its worst
# row's relative L2 error (floored as for the kernel's gradients), the loss
# and the gradient norm relatively. The two paths round to bf16 at other
# places in each layer's forward and backward (2^-9 per rounding; the
# logits alone differ by ~1e-2, REFERENCE_ROW_RTOL's measurement), and the
# card's attention gradients carry the kernel's own roundings; a wrong
# mask, head or missing term moves whole rows by a sizeable fraction.
TRAIN_GRAD_ROW_RTOL = 5e-2
TRAIN_LOSS_RTOL = 1e-2
# The loss operator against its plain version (the same chunk loop on the
# card with ce_fold_reference / ce_grad_reference and fp32 products of the
# widened operands). Both take exact products of the same bf16 values and
# planes, sum them in fp32 in other orders (~1e-6 relative) and round dh
# and dW to bf16 once, so an element lands one bf16 step away only where
# its fp32 values straddle a rounding boundary: a sound row errs ~1e-4,
# and the gate is one bf16 step, 2^-8 (the CPU tests' against the fp32
# composition); a wrong chunk, column or scale moves whole rows. fp32
# operands: fp32 sums in other orders, 1e-5. The loss, relatively: 1e-5.
# Each kernel alone: the fold's log-sum-exp against the plain one's, whose
# sums of ~5e4 exponentials differ in order only (~1e-6 of ~11), within
# CE_LSE_ABS_TOL, and its label logits bit-equal (a copy); the gradient
# pass's fp32 g against the plain one's by the worst row within
# CE_GRAD_ROW_RTOL (expf against torch's exp, a few ulp; a wrong column,
# lse or scale errs by O(1)), and its three planes summing to its own g
# bit for bit (a lost plane, even lo at 2^-17 of g, breaks it).
UNEMBED_CE_ROW_RTOL = 2.0 ** -8
UNEMBED_CE_FP32_ROW_RTOL = 1e-5
UNEMBED_CE_LOSS_RTOL = 1e-5
CE_LSE_ABS_TOL = 1e-4
CE_GRAD_ROW_RTOL = 1e-5

QWEN, MAMBA, ZAMBA = "qwen2.5-3b", "mamba2-370m", "zamba2-1.2b"
MOON, MIXTRAL = "moonshot-v1-16b-a3b", "mixtral-8x22b"
AUDIO, VLM = "musicgen-large", "qwen2-vl-72b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 8, 3e-4
# each arch's training batch at TRAIN_SEQ: qwen2.5-3b's fits 80 GB at 2
TRAIN_BATCHES = {QWEN: TRAIN_BATCH, MAMBA: 8, ZAMBA: 8, MOON: TRAIN_BATCH,
                 AUDIO: 8, VLM: TRAIN_BATCH}
# the training cells' depth cuts, each keeping 16 B a parameter of fp32
# masters, gradients and AdamW mu / nu: moonshot-v1-16b-a3b, 0.671 B +
# 0.5706 B a layer: five layers take 56.3 GB, and the logits and
# activations of B = 2 x S = 2048 ~10 GB more (six would leave < 8 GB
# free); qwen2-vl-72b, 2.491 B (embed and lm_head) + 0.8777 B a layer:
# one layer takes 53.91 GB, and the fp32 logits of B = 2 x S = 2048
# (2 x 2048 x 152064, 2.49 GB), their gradient and the fp32 unembedding
# table (4.98 GB) come on top (two layers would hold 67.95 GB of state
# before any activation). musicgen-large is not cut: 3.230 B x 16 B =
# 51.68 GB, and B = 8 x S = 2048 saves 48 layer inputs of 67 MB.
TRAIN_LAYERS = {MOON: 5, VLM: 1}
# the training cells' learning rate where TRAIN_LR's is too high. On N(0,
# 1) stand-in embeddings, which say nothing of the labels, musicgen-large
# (no warmup) spikes by its third or fourth step at every rate tried and
# at 3e-4 does not recover (8.04 -> 12.10 over 8 steps; 1e-4: -> 6.01
# through 14.60; 5e-5: -> 5.90 through 9.29; 3e-5: -> 6.13 through 10.38);
# qwen2-vl-72b's one layer went 13.61 -> 12.34 at 3e-4, its last step up,
# and falls at every step at 1e-4 (-> 12.97)
TRAIN_LRS = {AUDIO: 5e-5, VLM: 1e-4}
# the serving cells' depth cuts: qwen2-vl-72b in bf16, 2 x 0.8777 B =
# 1.755 GB a layer: 32 of its 80 layers and embed + lm_head are 61.15 GB
# of weights, with the fp32 unembedding table (4.98 GB) and the ring
# caches (8 x 2048 tokens x 8 heads x 128 x k, v x 32 layers, 2.15 GB)
# 68.3 GB before activations (28 layers if the peak passed 76 GB)
SERVE_LAYERS = {VLM: 32}
# qwen2-vl's image stand-ins: (frames, height, width) patches of an image
# between text, at full width and in the tiny checks (vision_grid_pos)
VISION_GRID, TINY_VISION_GRID = (2, 16, 16), (2, 4, 4)
# the card-vs-CPU checks' tiny configs: reduced(), with five layers for
# zamba2-1.2b, so that its shared block runs three times (layers 0, 2, 4);
# the MoE ones keep reduced()'s 4 experts, top 2 (mixtral-8x22b: its
# window of 64, which the prompts of 100 pass)
TINY_OVERRIDES = {ZAMBA: {"num_layers": 5}}
# A token whose expert set differs between the card and the CPU must sit
# at a near-tie: its k-th and (k+1)-th CPU router probabilities within 1e-2
# of the k-th. bf16 rounds the hidden state the router sees to 2^-8 of its
# size, in other places on the two devices (the card's flash kernel also
# rounds P to bf16), which moves a router logit by ~1e-3 of its size and a
# probability by as much of itself: rounding alone can swap two experts
# only within a few times that. A token that flipped at an earlier layer
# may flip again at any margin (its state moved by O(1)). Rows of flipped
# tokens move by O(1), not by rounding, and are not held to the row gates;
# the gradients are compared with the card routed as the CPU was.
FLIP_MARGIN = 1e-2
CARD_BYTES = 80e9
# [roofline]: the dry run's peak memory of a training step or a prefill
# against the card's, 15% either way. The dry run counts the
# live storages, each rounded to 512 bytes as the caching allocator rounds
# them; it does not see the flash backward's fp32 scratch (<= 0.4 GB at
# the cells' shapes) nor blocks the allocator hands out larger than asked.
ROOFLINE_PEAK_RANGE = (0.85, 1.15)
BATCH, CACHE_LEN, NEW_TOKENS = 8, 2048, 32
PROMPT_LENS = (256, 1024)
# the resume phase: run A's steps, run B's steps before its save, and the
# disk its checkpoint needs (params, mu, nu in fp32: 40.84 GB, with room)
RESUME_STEPS, RESUME_SAVE_AT, RESUME_DISK_BYTES = 6, 3, 45e9
# the boot phase: the launchers' runs, each in a process of its own, and
# the longest one may take (a cold full-width training boot with its save)
BOOT_TRAIN_ARGS = ["--full", "--arch", QWEN, "--nodes", "1", "--batch",
                   str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                   "--ckpt-every", "2"]
BOOT_SERVE_ARGS = ["--full", "--arch", MAMBA, "--nodes", "1"]
BOOT_CHILD_TIMEOUT_S = 420
# the control for the warm training boot: a fresh process that loads the
# boot's kernel library and resumes its checkpoint as train_loop does, as
# the warm launcher does after the runtime, but without the runtime and
# its own reads of the checkpoint; part by part, then a second step.
# argv: workdir, library directory, arch, batch, sequence length
RESUME_ALONE = """
import sys, time
from pathlib import Path
import torch
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.loader import Loader
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.kernels import build
from repro_torch.launch.boot import init_card, report_restore
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_map
from repro_torch.train.step import loss_and_grads, make_train_step
root, lib, arch = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
batch, seq = int(sys.argv[4]), int(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build(directory=lib)
init_card(torch.device("cuda"))
ck = Checkpointer(HdfsCluster(root / "hdfs", num_groups=8,
                              block_size=1 << 20), width=8)
step = ck.latest_step()
print(f"resuming params/opt from step {step}", flush=True)
marks = [("start", time.perf_counter())]

def mark(name):
    torch.cuda.synchronize()
    marks.append((name, time.perf_counter()))

# train_loop's resume, part by part
model = Model(get_config(arch), device="cuda")
params = model.init_like(dtype=getattr(torch, model.cfg.param_dtype))
opt = adamw_init(params)
mark("schema")
params, tail = ck.restore_planned(step, params, opt, async_tail=True,
                                  device=model.device)
mark("wave 0")
(opt,) = tail.result()
mark("tail")
cfg = AdamWConfig()
loader = Loader(SyntheticStream(model.cfg.vocab_size, 0), batch, seq,
                model.device)
data = loader(step)
mark("batch")
grads = tree_map(torch.zeros_like, params)
mark("first step: gradient buffers")
loss, _ = loss_and_grads(model, params, data, grads)
mark("forward and backward")
params, opt, _ = adamw_update(params, grads, opt, cfg, lr=cfg.lr)
del grads
print(f"step {step:5d}  loss {float(loss):.4f}", flush=True)
mark("AdamW")
params, opt, m = make_train_step(model, cfg)(params, opt, loader(step + 1))
print(f"step {step + 1:5d}  loss {float(m['loss']):.4f}", flush=True)
mark("second step")
report_restore(ck.timings)
print("parts: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f}s"
                            for a, b in zip(marks, marks[1:])), flush=True)
print(f"first step: {marks[-2][1] - marks[-5][1]:.2f}s", flush=True)
"""
# the flash backward's time beside SDPA's backward: rounds of one timing
# each, alternating, and their medians
YARDSTICK_ROUNDS = 7
# (name, B, S, Hq, Hkv, D, window, causal) of the flash backward's checks:
# the training shape (qwen2.5-3b's heads at B = 2, S = 2048), then its edges
BWD_CASES = [("train", TRAIN_BATCH, TRAIN_SEQ, 16, 2, 128, 0, True),
             ("ragged", 2, 1000, 16, 2, 128, 0, True),
             ("window", 2, 2048, 16, 2, 128, 256, True),
             ("d64", 2, 512, 8, 2, 64, 0, True),
             ("noncausal", 2, 1000, 16, 2, 128, 0, False),
             ("group1", 2, 512, 4, 4, 128, 0, True),
             ("zamba2", TRAIN_BATCHES[ZAMBA], TRAIN_SEQ, 32, 32, 64, 4096,
              True),
             ("moonshot", TRAIN_BATCHES[MOON], TRAIN_SEQ, 16, 16, 128, 0,
              True),
             ("musicgen", TRAIN_BATCHES[AUDIO], TRAIN_SEQ, 32, 32, 64, 0,
              True),
             ("qwen2vl", TRAIN_BATCHES[VLM], TRAIN_SEQ, 64, 8, 128, 0, True)]
# the timed shapes of the flash backward: the training paths' (qwen2.5-3b's
# first, whose time the kernels line carries)
BWD_TIMED = ("train", "zamba2", "moonshot", "musicgen", "qwen2vl")
# (name, B, S, H, P, G, N) of the SSD backward's checks: mamba2-370m's
# training shape, then a ragged S, two groups, P = 32 with N = 16, N = 64,
# zamba2-1.2b's training shape (H = 64, N = 64), all under the model's
# dt/A draws (ssd_train_inputs); then one under the JAX tests' draws
# (ssd_inputs), whose dt ~ 1 makes dx lean on M: one bf16 rounding of M
# (its lo part lost) errs ~8e-2 there, ~5e-3 under the model's
# (kernels/ref.py::ssd_backward_tiles, split=True)
SSD_BWD_CASES = [("train", TRAIN_BATCHES[MAMBA], TRAIN_SEQ, 32, 64, 1, 128),
                 ("ragged", 2, 1000, 32, 64, 1, 128),
                 ("grouped", 2, 512, 8, 64, 2, 128),
                 ("p32n16", 2, 300, 8, 32, 1, 16),
                 ("n64", 2, 260, 8, 64, 2, 64),
                 ("zamba2", TRAIN_BATCHES[ZAMBA], TRAIN_SEQ, 64, 64, 1, 64)]
# the timed shapes of the SSD backward, mamba2-370m's first (the kernels
# line's)
SSD_BWD_TIMED = ("train", "zamba2")
SSD_BWD_JAX_CASES = [("jaxdt", 2, 512, 8, 64, 1, 128)]
# (name, rows, d, V, dtype, tied) of the training loss's vocab-chunked
# operator (kernels/unembed_ce.py): mamba2-370m's benchmark cell (16 x
# 2048 rows over 1024 x 50,432, 9 chunks; the timed shape), its phase 7
# batch (8 x 2048, 5 chunks), a tied table (a transposed view of the
# embedding) at qwen2.5-3b's training shape (2 x 2048 rows over 2048 x
# 151,936) and fp32 operands
# at odd widths (the kernels' 4-byte loads)
UNEMBED_CE_CASES = [
    ("cell", 16 * TRAIN_SEQ, 1024, 50432, "bfloat16", False),
    ("train", TRAIN_BATCHES[MAMBA] * TRAIN_SEQ, 1024, 50432, "bfloat16",
     False),
    ("tied", TRAIN_BATCH * TRAIN_SEQ, 2048, 151936, "bfloat16", True),
    ("fp32", 1000, 256, 1001, "float32", False)]
# [ssd knobs]: the SSD kernels' bf16-intra instances, the card's
# Rules(ssd_compute_dtype="bfloat16"), which round M (and, backward, Q) to
# bf16 once. Each is held to the plain fp32 version by the worst row
# (floored at GRAD_ROW_FLOOR of the median row, as the gradients' gates:
# the JAX tests' draws leave rows of y that cancel) within SSD_KNOB_BUDGET
# times the plain bf16 version's own worst row against plain fp32 at the
# same inputs, or within the default instance's gate where that is larger
# (an output the knob leaves as it was: the final state, dD); and apart
# from the default instance by more than SSD_Y_ROW_RTOL, so that the flag
# provably reaches the kernel. Emulated on the CPU at B = 2, S = 1024, H =
# 4, P = 64, N = 128 (tests/test_torch_ssd_knobs.py): y 3.4e-2 against the
# plain bf16 version's 7.6e-2; dx 1.07e-1 against 8.2e-2. Under the JAX
# tests' draws (ssd_inputs), whose dt ~ 1 makes y and dx lean on M; under
# the model's one bf16 part of M moves dx by ~5e-3, less than the apart
# gate. The forward at the serving prefill's shapes, the backward at the
# training shapes (mamba2-370m's, zamba2-1.2b's); then mamba2-370m at full
# width under the knob: a prefill of KNOB_PREFILL and KNOB_TRAIN_STEPS
# steps at TRAIN_BATCHES x TRAIN_SEQ.
SSD_KNOB_BUDGET = 1.5
SSD_KNOB_FWD_CASES = [("main", BATCH, PROMPT_LENS[1], 32, 64, 1, 128),
                      ("zamba2", BATCH, PROMPT_LENS[1], 64, 64, 1, 64)]
SSD_KNOB_BWD_CASES = [
    ("train", TRAIN_BATCHES[MAMBA], TRAIN_SEQ, 32, 64, 1, 128),
    ("zamba2", TRAIN_BATCHES[ZAMBA], TRAIN_SEQ, 64, 64, 1, 64)]
KNOB_PREFILL, KNOB_TRAIN_STEPS = (BATCH, PROMPT_LENS[1]), 3
# [tune kernels] and [tune boot]: the forward kernels' shapes on the main
# paths, the serving prefills (8 prompts padded to 1024) and musicgen-large's
# training step; (name, B, S, Hq, Hkv, D, window) for flash, (name, B, S, H,
# P, G, N) for the SSD
TUNE_FLASH_SHAPES = [
    (QWEN, BATCH, PROMPT_LENS[1], 16, 2, 128, 0),
    (ZAMBA, BATCH, PROMPT_LENS[1], 32, 32, 64, 4096),
    (AUDIO, BATCH, PROMPT_LENS[1], 32, 32, 64, 0),
    (MOON, BATCH, PROMPT_LENS[1], 16, 16, 128, 0),
    (VLM, BATCH, PROMPT_LENS[1], 64, 8, 128, 0),
    (f"{AUDIO} train", TRAIN_BATCHES[AUDIO], TRAIN_SEQ, 32, 32, 64, 0)]
TUNE_SSD_SHAPES = [(MAMBA, BATCH, PROMPT_LENS[1], 32, 64, 1, 128),
                   (ZAMBA, BATCH, PROMPT_LENS[1], 64, 64, 1, 64)]
# the boot's sweep: timed rounds (of autotune.INNER calls) a config
TUNE_REPEATS = 3
# the serving cells that prefill under the tuned profile beside the
# defaults; musicgen-large also takes training steps under it
TUNED_SERVE = (AUDIO, ZAMBA)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    say(phase, "FAIL " + msg)
    raise SystemExit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s); "
        "TF32 off for matmul and cuDNN")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    say("build", f"{lib.path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            say("build", line.strip())


def phase_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_reference, row_rel_err

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, s, hq, hkv, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for h in (hq, hkv, hkv)]

    # (name, B, S, Hq, Hkv, D, window, causal): the serving path's prefill
    # shape first (8 prompts padded to 1024, qwen2.5-3b heads), then its
    # variants; non-causal at S = 1000, where only the `kpos < Sk` mask
    # hides the zero keys past Sk in the last 128-key tile; then
    # zamba2-1.2b's shared block at the same prefill (32 heads of 64, MHA,
    # its window of 4096), moonshot-v1-16b-a3b's (16 heads of 128, MHA),
    # musicgen-large's (32 heads of 64, MHA, no window) and qwen2-vl-72b's
    # (64 / 8 heads of 128)
    cases = [("main", BATCH, PROMPT_LENS[1], 16, 2, 128, 0, True),
             ("ragged", BATCH, 1000, 16, 2, 128, 0, True),
             ("window", BATCH, 1024, 16, 2, 128, 256, True),
             ("d64", 4, 512, 8, 2, 64, 0, True),
             ("noncausal", 2, 1000, 16, 2, 128, 0, False),
             ("zamba2", BATCH, PROMPT_LENS[1], 32, 32, 64, 4096, True),
             ("moonshot", BATCH, PROMPT_LENS[1], 16, 16, 128, 0, True),
             ("musicgen", BATCH, PROMPT_LENS[1], 32, 32, 64, 0, True),
             ("qwen2vl", BATCH, PROMPT_LENS[1], 64, 8, 128, 0, True)]
    worst, failed = 0.0, []
    for name, b, s, hq, hkv, d, window, causal in cases:
        q, k, v = qkv(b, s, hq, hkv, d)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                                  causal=causal, window=window).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        row = row_rel_err(out, ref)
        worst = max(worst, err)
        ok = math.isfinite(row) and row <= KERNEL_ROW_RTOL
        if not ok:
            failed.append(name)
        say("kernels", f"flash_attention {name} B={b} S={s} Hq={hq} Hkv={hkv}"
            f" D={d} window={window} causal={causal}: worst row rel L2 err "
            f"{row:.3e} (tol "
            f"{KERNEL_ROW_RTOL}), all rel L2 {rel:.3e}, max abs err "
            f"{err:.3e}, mean |ref| {ref.float().abs().mean().item():.3e} "
            f"{'ok' if ok else 'FAIL'}")
    if failed:
        fail("kernels", f"flash_attention disagrees with plain: {failed}")

    timed = {}
    for name in ("main", "zamba2", "moonshot", "musicgen", "qwen2vl"):
        _, b, s, hq, hkv, d, window, _ = next(c for c in cases
                                              if c[0] == name)
        # a window past S is plain causal attention, as SDPA's is_causal
        assert not window or window >= s
        q, k, v = qkv(b, s, hq, hkv, d)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                             window=window), iters=50)
        lse_ms = cuda_ms(lambda: flash_attention(
            q, k, v, causal=True, window=window, return_lse=True), iters=50)
        plain_ms = cuda_ms(lambda: attention_reference(
            qt, kt, vt, causal=True, window=window), iters=5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=50)
        bound_ms, bound_by = attention_bound(b, hq, hkv, s, d)
        tflops = attention_flops(b, hq, s, d) / ms / 1e9
        say("kernels", f"flash_attention {name}: {ms:.4f} ms ({tflops:.1f} "
            f"TFLOP/s), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
            f"({library_ms / ms:.3f}x the kernel's speed), bound "
            f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% "
            f"reached); with the LSE written (training) {lse_ms:.4f} ms, on "
            f"{card}")
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "launches": None, "max_abs_err": worst, **timed["main"]}


def phase_flash_bwd_kernels(card: str) -> tuple[dict, dict]:
    """The backward kernel (both paths) and the forward's LSE against their
    plain versions at the training path's shape and its edges; the
    backward's time beside the plain version's, SDPA's backward and its
    bound. Returns the kernels-line entries of the fast and the
    deterministic path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         attention_lse_reference, row_rel_err)

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(b, s, h, d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def heads_first(*ts):
        return [t.transpose(1, 2) for t in ts]

    def sdpa(q, k, v, causal, window):
        """SDPA in its layout on leaves that require grad, as the
        library's yardstick: (inputs, output). A window past Sq hides
        nothing: plain (causal) attention."""
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        window = window if window < q.shape[1] else 0
        if window:
            r = torch.arange(q.shape[1], device="cuda")[:, None]
            c = torch.arange(k.shape[1], device="cuda")[None, :]
            mask = (c > r - window) & ((r >= c) if causal else True)
        out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and not window,
            enable_gqa=True)
        return (qs, ks, vs), out

    cases = BWD_CASES
    worst, det_worst, failed = 0.0, 0.0, []
    for name, b, s, hq, hkv, d, window, causal in cases:
        q, k, v, do = (randn(b, s, h, d) for h in (hq, hkv, hkv, hq))
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        same = torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                window=window))
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        _, lse_ref = attention_lse_reference(*heads_first(q, k, v),
                                             causal=causal, window=window)
        lse_err = (lse - lse_ref).abs().max().item()
        refs = [t.transpose(1, 2) for t in attention_backward_reference(
            *heads_first(q, k, v, do), causal=causal, window=window)]
        errs = [row_rel_err(x, r, floor=GRAD_ROW_FLOOR)
                for x, r in zip((dq, dk, dv), refs)]
        leaves, o_lib = sdpa(q, k, v, causal, window)
        lib = torch.autograd.grad(o_lib, leaves, do.transpose(1, 2))
        lib_errs = [row_rel_err(x.transpose(1, 2), r, floor=GRAD_ROW_FLOOR)
                    for x, r in zip(lib, refs)]
        worst = max([worst] + [(x.float() - r).abs().max().item()
                               for x, r in zip((dq, dk, dv), refs)])
        ok = (same and math.isfinite(lse_err) and lse_err <= LSE_ABS_TOL
              and all(math.isfinite(e) and e <= GRAD_ROW_RTOL for e in errs))
        if not ok:
            failed.append(name)
        # the deterministic path: the same gate, and the same bits twice
        det = [flash_attention_bwd_deterministic(
            q, k, v, lse, do, causal=causal, window=window) for _ in range(2)]
        torch.cuda.synchronize()
        det_errs = [row_rel_err(x, r, floor=GRAD_ROW_FLOOR)
                    for x, r in zip(det[0], refs)]
        det_equal = all(torch.equal(x, y) for x, y in zip(*det))
        det_worst = max([det_worst] + [(x.float() - r).abs().max().item()
                                       for x, r in zip(det[0], refs)])
        det_ok = det_equal and all(math.isfinite(e) and e <= GRAD_ROW_RTOL
                                   for e in det_errs)
        if not det_ok:
            failed.append(f"{name} (deterministic)")
        say("kernels", f"flash_bwd {name} B={b} S={s} Hq={hq} Hkv={hkv} D={d}"
            f" window={window} causal={causal}: dq/dk/dv worst row rel L2 "
            f"err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
            f"{GRAD_ROW_RTOL}, floor {GRAD_ROW_FLOOR} x median), SDPA's "
            f"{lib_errs[0]:.3e}/{lib_errs[1]:.3e}/{lib_errs[2]:.3e}; lse max "
            f"abs err {lse_err:.3e} (tol {LSE_ABS_TOL}); forward output with "
            f"the LSE bit-equal to without: {same} {'ok' if ok else 'FAIL'}")
        say("kernels", f"flash_bwd deterministic {name}: dq/dk/dv worst row "
            f"rel L2 err {det_errs[0]:.3e}/{det_errs[1]:.3e}/{det_errs[2]:.3e}"
            f" (tol {GRAD_ROW_RTOL}); two calls bit-equal: {det_equal} "
            f"{'ok' if det_ok else 'FAIL'}")
    if failed:
        fail("kernels", f"flash_attention_bwd disagrees with plain: {failed}")

    timed = {}
    for name in BWD_TIMED:
        _, b, s, hq, hkv, d, window, causal = next(c for c in cases
                                                   if c[0] == name)
        q, k, v, do = (randn(b, s, h, d) for h in (hq, hkv, hkv, hq))
        _, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        timed[name] = _time_flash_bwd(card, name, q, k, v, lse, do, causal,
                                      window, sdpa, heads_first)
        del q, k, v, do, lse
    det_ms = timed["train"].pop("det_ms")
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/attention.py:51",
             "launches": None, "max_abs_err": worst, **timed["train"]}
    return entry, dict(entry, name="flash_attention_bwd_deterministic",
                       max_abs_err=det_worst, ms=det_ms)


def _time_flash_bwd(card, name, q, k, v, lse, do, causal, window, sdpa,
                    heads_first) -> dict:
    """The flash backward's time at one shape beside its plain version,
    SDPA's backward and its bound; at the first timed shape also the
    deterministic path, two fast calls compared, and the profiler's split.
    Returns the kernels-line numbers (and the deterministic path's ms)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         row_rel_err)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    kw = dict(causal=causal, window=window)
    # the kernel and SDPA's backward timed in turn, round by round, so
    # that a change in the host or the card's clocks during the call
    # moves both: the medians are the table's numbers
    leaves, o_lib = sdpa(q, k, v, causal, window)
    do_t = do.transpose(1, 2)
    rounds = [(cuda_ms(lambda: flash_attention_bwd(q, k, v, lse, do, **kw),
                       iters=10),
               cuda_ms(lambda: torch.autograd.grad(
                   o_lib, leaves, do_t, retain_graph=True), iters=10))
              for _ in range(YARDSTICK_ROUNDS)]
    del leaves, o_lib
    ms = statistics.median(r[0] for r in rounds)
    library_ms = statistics.median(r[1] for r in rounds)
    say("kernels", f"flash_attention_bwd {name}, kernel / SDPA backward in "
        f"{YARDSTICK_ROUNDS} alternating rounds of 10 calls: "
        f"{', '.join(f'{a:.4f}/{b:.4f}' for a, b in rounds)} ms; medians "
        f"{ms:.4f} / {library_ms:.4f} ms, on {card}")
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True, **kw),
                     iters=20)
    plain_ms = cuda_ms(lambda: attention_backward_reference(
        *heads_first(q, k, v, do), **kw), iters=3, warmup=1)
    pairs = unmasked_pairs(s, s, causal, window)
    bound_ms, bound_by = attention_bwd_bound(b, hq, hkv, s, d, pairs)
    tflops = 10 * d * pairs * b * hq / ms / 1e9
    say("kernels", f"flash_attention_bwd {name}: {ms:.4f} ms ({tflops:.1f} "
        f"TFLOP/s at 10*D per pair), plain {plain_ms:.4f} ms, SDPA backward "
        f"{library_ms:.4f} ms ({library_ms / ms:.3f}x the kernel's speed), "
        f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% "
        f"reached); forward with the LSE at this shape {fwd_ms:.4f} ms, on "
        f"{card}")
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    if name != BWD_TIMED[0]:
        return out
    det_ms = cuda_ms(lambda: flash_attention_bwd_deterministic(
        q, k, v, lse, do, **kw), iters=20)
    say("kernels", f"flash_bwd deterministic {name}: {det_ms:.4f} ms "
        f"({10 * d * pairs * b * hq / det_ms / 1e9:.1f} TFLOP/s), "
        f"{det_ms / ms:.3f}x the fast path's {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({100 * bound_ms / det_ms:.1f}% reached), on "
        f"{card}")
    # The kernels sum dQ, dK and dV across blocks by fp32 atomic adds, in the
    # order the blocks finish: two calls on the same inputs, compared.
    first, second = (flash_attention_bwd(q, k, v, lse, do, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    runs = [row_rel_err(x, y, floor=GRAD_ROW_FLOOR)
            for x, y in zip(first, second)]
    equal = [torch.equal(x, y) for x, y in zip(first, second)]
    say("kernels", f"flash_attention_bwd {name} run to run: dq/dk/dv worst "
        f"row rel L2 difference {runs[0]:.3e}/{runs[1]:.3e}/{runs[2]:.3e} "
        f"(floor {GRAD_ROW_FLOOR} x median), bit-equal {equal[0]}/"
        f"{equal[1]}/{equal[2]}")
    profile_window(f"flash_bwd {name}", lambda: flash_attention_bwd(
        q, k, v, lse, do, **kw), card, share_of="flash_bwd")
    profile_window(f"flash_bwd deterministic {name}",
                   lambda: flash_attention_bwd_deterministic(
                       q, k, v, lse, do, **kw), card, share_of="flash_bwd")
    return dict(out, det_ms=det_ms)


def ssd_inputs(gen, b: int, s: int, h: int, p: int, g: int, n: int):
    """The JAX kernel tests' distributions: x ~ N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(U[0, 1]), B/C ~ N(0, 1/4), D = 1; x, B, C
    in bf16, the rest fp32, on the card."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, s, h, p).bfloat16()
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
    B = (randn(b, s, g, n) * 0.5).bfloat16()
    C = (randn(b, s, g, n) * 0.5).bfloat16()
    D = torch.ones((h,), device="cuda")
    return x, dt, A, B, C, D


def ssd_train_inputs(gen, b: int, s: int, h: int, p: int, g: int, n: int):
    """``ssd_inputs`` with dt and A drawn as the model initialises them
    (dt log-uniform in [1e-3, 1e-1], A = -U[1, 16]): decays from ~1 to
    ~e^-50 over a tile of 32, so the state carried between tiles, and its
    gradient, move every output. Under ``ssd_inputs``' dt a tile decays by
    ~e^-30, and a fault in what crosses tiles would hide."""
    import torch
    x, _, _, B, C, D = ssd_inputs(gen, b, s, h, p, g, n)
    u = torch.rand((b, s, h), generator=gen, device="cuda")
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    A = -(1 + 15 * torch.rand((h,), generator=gen, device="cuda"))
    return x, dt, A, B, C, D


def phase_ssd_kernels(card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import row_rel_err, ssd_chunked_reference
    from repro_torch.kernels.ssd import ssd_chunked_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    scfg = get_config(MAMBA).ssm
    chunk = scfg.chunk_size
    heads = scfg.expand * get_config(MAMBA).d_model // scfg.head_dim
    # (name, B, S, H, P, G, N): the serving path's prefill shape first (8
    # prompts padded to 1024, mamba2-370m's heads and state), then its
    # variants (S one position into a second tile), tiny mamba2-370m's
    # shape and zamba2-1.2b's prefill (64 heads, N = 64)
    cases = [("main", BATCH, PROMPT_LENS[1], heads, scfg.head_dim, 1,
              scfg.state_dim),
             ("ragged", BATCH, 1000, heads, scfg.head_dim, 1, scfg.state_dim),
             ("s65", 2, 65, heads, scfg.head_dim, 1, scfg.state_dim),
             ("grouped", 2, 512, 8, 64, 2, 64),
             ("tiny", 2, 100, 16, 32, 1, 16),
             ("zamba2", BATCH, PROMPT_LENS[1], 64, 64, 1, 64)]
    worst, failed = 0.0, []
    for name, b, s, h, p, g, n in cases:
        args = ssd_inputs(gen, b, s, h, p, g, n)
        y, st = ssd_chunked_kernel(*args)
        torch.cuda.synchronize()
        y_ref, st_ref = ssd_chunked_reference(*args, chunk=chunk)
        y_row, st_row = row_rel_err(y, y_ref), row_rel_err(st, st_ref)
        err = (y.float() - y_ref.float()).abs().max().item()
        st_err = (st - st_ref).abs().max().item()
        worst = max(worst, err)
        ok = (math.isfinite(y_row) and y_row <= SSD_Y_ROW_RTOL
              and math.isfinite(st_row) and st_row <= SSD_STATE_ROW_RTOL)
        if not ok:
            failed.append(name)
        say("kernels", f"ssd {name} B={b} S={s} H={h} P={p} G={g} N={n}: "
            f"y worst row rel L2 err {y_row:.3e} (tol {SSD_Y_ROW_RTOL}), "
            f"max abs {err:.3e}; final_state worst row {st_row:.3e} (tol "
            f"{SSD_STATE_ROW_RTOL}), max abs {st_err:.3e}, max |state| "
            f"{st_ref.abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
    if failed:
        fail("kernels", f"ssd disagrees with plain: {failed}")

    timed = {}
    for name in ("main", "zamba2"):
        _, b, s, h, p, g, n = next(c for c in cases if c[0] == name)
        args = ssd_inputs(gen, b, s, h, p, g, n)
        ms = cuda_ms(lambda: ssd_chunked_kernel(*args), iters=20)
        plain_ms = cuda_ms(lambda: ssd_chunked_reference(*args, chunk=chunk),
                           iters=5, warmup=1)
        bound_ms, bound_by = ssd_bound(b, s, h, p, g, n)
        fp32_ms, fp32_by = ssd_bound(b, s, h, p, g, n,
                                     peak_flops=PEAK_FP32_FLOPS)
        tflops = ssd_flops(b, s, h, p, g, n) / ms / 1e9
        say("kernels", f"ssd {name}: {ms:.4f} ms ({tflops:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, no library call, bound "
            f"{bound_ms:.4f} ms ({bound_by}, bf16 tensor cores, the "
            f"kernel's arithmetic; {100 * bound_ms / ms:.1f}% reached), "
            f"fp32 CUDA-core bound {fp32_ms:.4f} ms ({fp32_by}) on {card}")
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:27", "launches": None,
            "max_abs_err": worst, **timed["main"]}


def phase_ssd_bwd_kernels(card: str) -> dict:
    """The SSD backward against autograd of the plain version at the
    training shape and its edges, two calls bit-equal; its workspace, its
    time beside the plain version's and its bound. Returns its kernels-line
    entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import row_rel_err, ssd_backward_reference
    from repro_torch.kernels.ssd import (ssd_bwd_workspace_bytes,
                                         ssd_bwd_workspace_floats,
                                         ssd_chunked_bwd_kernel)

    gen = torch.Generator(device="cuda").manual_seed(2)
    chunk = get_config(MAMBA).ssm.chunk_size
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    worst, failed = 0.0, []
    for draw, (name, b, s, h, p, g, n) in (
            [(ssd_train_inputs, c) for c in SSD_BWD_CASES]
            + [(ssd_inputs, c) for c in SSD_BWD_JAX_CASES]):
        args = draw(gen, b, s, h, p, g, n)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
        got = [ssd_chunked_bwd_kernel(*args, dy) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*got))
        refs = ssd_backward_reference(*args, dy, chunk=chunk)
        errs = [row_rel_err(x, r, floor=GRAD_ROW_FLOOR)
                for x, r in zip(got[0], refs)]
        worst = max([worst] + [(x.float() - r).abs().max().item()
                               for x, r in zip(got[0], refs)])
        ok = same and all(math.isfinite(e) and e <= GRAD_ROW_RTOL
                          for e in errs)
        if not ok:
            failed.append(name)
        say("kernels", f"ssd_bwd {name} B={b} S={s} H={h} P={p} G={g} N={n}:"
            " worst row rel L2 err " + ", ".join(
                f"{k} {e:.3e}" for k, e in zip(names, errs))
            + f" (tol {GRAD_ROW_RTOL}, floor {GRAD_ROW_FLOOR} x median); two "
            f"calls bit-equal: {same} {'ok' if ok else 'FAIL'}")
        del args, dy, got, refs
    if failed:
        fail("kernels", f"ssd_chunked_bwd_kernel disagrees with plain: "
             f"{failed}")

    timed = {}
    for name in SSD_BWD_TIMED:
        _, b, s, h, p, g, n = next(c for c in SSD_BWD_CASES if c[0] == name)
        args = ssd_train_inputs(gen, b, s, h, p, g, n)
        dy = torch.randn((b, s, h, p), generator=gen,
                         device="cuda").bfloat16()
        ws = ssd_bwd_workspace_bytes(b, s, h, p, n)
        # the dry run and the autograd backward size it in Python
        if ws != 4 * ssd_bwd_workspace_floats(b, s, h, p, n):
            fail("kernels", f"ssd_bwd {name}: the library's workspace {ws} "
                 "bytes is not ssd_bwd_workspace_floats' "
                 f"{4 * ssd_bwd_workspace_floats(b, s, h, p, n)}")
        ms = cuda_ms(lambda: ssd_chunked_bwd_kernel(*args, dy), iters=10)
        plain_ms = cuda_ms(lambda: ssd_backward_reference(*args, dy,
                                                          chunk=chunk),
                           iters=2, warmup=1)
        bound_ms, bound_by = ssd_bwd_bound(b, s, h, p, g, n)
        flops = ssd_bwd_flops(b, s, h, p, g, n)
        say("kernels", f"ssd_bwd {name} B={b} S={s} H={h} P={p} G={g} N={n}:"
            f" {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of "
            f"{flops / 1e9:.1f} GFLOP), plain {plain_ms:.4f} ms, library: "
            f"none, bound {bound_ms:.4f} ms ({bound_by}, bf16 tensor cores, "
            f"the kernel's arithmetic; {100 * bound_ms / ms:.1f}% reached); "
            f"workspace {ws} bytes ({ws / 1e9:.3f} GB: both states per tile "
            f"as bf16 hi/lo planes, dA/dD per tile), on {card}")
        profile_window(f"ssd_bwd {name}",
                       lambda: ssd_chunked_bwd_kernel(*args, dy), card,
                       share_of="ssd_bwd")
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        del args, dy
    return {"name": "ssd_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_bwd.cu",
            "replaces": "src/repro/models/ssm.py:37", "launches": None,
            "max_abs_err": worst, **timed[SSD_BWD_TIMED[0]]}


def knob_ptxas() -> None:
    """ptxas's registers and spills of every bf16-intra instance beside
    its default one: a spill, or a forward instance past the 168-register
    cap of two 6-warp blocks an SM, fails."""
    from repro_torch.kernels import build
    entries = ptxas_entries(build.build().ptxas_log)
    bad = []
    for name, (regs, spill) in sorted(entries.items()):
        one = re.search(r"(ssd_fwd_kernelILi\d+ELi\d+ELi\d+|"
                        r"ssd_bwd_grad_kernelILi\d+ELi\d+)ELi1EE", name)
        if not one:
            continue
        default = entries.get(name.replace(one.group(0),
                                           one.group(1) + "ELi2EE"), [None])
        cap = 168 if "fwd" in one.group(1) else 255
        ok = spill == 0 and regs is not None and regs <= cap
        if not ok:
            bad.append(one.group(1))
        say("ssd knobs", f"ptxas {one.group(1)} bf16-intra: {regs} registers"
            f", {spill} bytes spilled (the default instance: {default[0]} "
            f"registers) {'ok' if ok else 'FAIL'}")
    if not bad:
        return
    fail("ssd knobs", f"bf16-intra instances that spill or pass the cap: "
         f"{bad}")


def phase_ssd_knobs_kernels(card: str) -> tuple[dict, dict, float]:
    """The bf16-intra instances of the SSD forward (at the serving
    prefill's shapes) and backward (at the training shapes) against the
    plain versions, by SSD_KNOB_BUDGET's gates; the backward two calls
    bit-equal; each one's time beside the default instance's (in turns:
    default, bf16, bf16, default), the plain bf16 version's and its bound;
    ptxas's report of every instance. Returns the kernels-line entries of
    both and the phase's budget (the largest of its gates), which the
    model's run under the knob is held to."""
    import torch
    from repro_torch.kernels.ref import (row_rel_err, ssd_backward_reference,
                                         ssd_chunked_reference)
    from repro_torch.kernels.ssd import (ssd_chunked_bwd_kernel,
                                         ssd_chunked_bwd_kernel_bf16,
                                         ssd_chunked_kernel,
                                         ssd_chunked_kernel_bf16)

    knob_ptxas()
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16

    def row(a, r):
        return row_rel_err(a, r, floor=GRAD_ROW_FLOOR)

    def turns(default, knob, iters):
        """(knob ms, default ms), each the mean of two timings taken in
        turns: default, knob, knob, default."""
        ms = {"default": [], "knob": []}
        for way in ("default", "knob", "knob", "default"):
            ms[way].append(cuda_ms(knob if way == "knob" else default,
                                   iters=iters))
        return statistics.mean(ms["knob"]), statistics.mean(ms["default"])

    budget, failed, entries = 0.0, [], {}
    worst = 0.0
    for name, b, s, h, p, g, n in SSD_KNOB_FWD_CASES:
        args = ssd_inputs(gen, b, s, h, p, g, n)
        y32, st32 = ssd_chunked_reference(*args, chunk=256)
        y16, _ = ssd_chunked_reference(*args, chunk=256, compute_dtype=bf16)
        y1, st1 = ssd_chunked_kernel_bf16(*args)
        y2, _ = ssd_chunked_kernel(*args)
        torch.cuda.synchronize()
        ref_err = row(y16, y32)
        gate = max(SSD_KNOB_BUDGET * ref_err, SSD_Y_ROW_RTOL)
        err, apart = row(y1, y32), row(y1, y2)
        st_err = row_rel_err(st1, st32)
        worst = max(worst, (y1.float() - y32.float()).abs().max().item())
        ok = (math.isfinite(err) and err <= gate and apart > SSD_Y_ROW_RTOL
              and math.isfinite(st_err) and st_err <= SSD_STATE_ROW_RTOL)
        budget = max(budget, gate)
        if not ok:
            failed.append(f"ssd {name}")
        say("ssd knobs", f"ssd_bf16 {name} B={b} S={s} H={h} P={p} G={g} "
            f"N={n}: y worst row against plain fp32 {err:.3e} (gate {gate:.3e}"
            f" = max({SSD_KNOB_BUDGET} x the plain bf16 version's {ref_err:.3e}"
            f", {SSD_Y_ROW_RTOL})); against the default instance {apart:.3e} "
            f"(must exceed {SSD_Y_ROW_RTOL}); final state {st_err:.3e} (tol "
            f"{SSD_STATE_ROW_RTOL}) {'ok' if ok else 'FAIL'}")
        if name == "main":
            ms, default_ms = turns(lambda: ssd_chunked_kernel(*args),
                                   lambda: ssd_chunked_kernel_bf16(*args), 20)
            plain_ms = cuda_ms(lambda: ssd_chunked_reference(
                *args, chunk=256, compute_dtype=bf16), iters=5, warmup=1)
            bound_ms, bound_by = ssd_bound(b, s, h, p, g, n)
            say("ssd knobs", f"ssd_bf16 {name}: {ms:.4f} ms, the default "
                f"instance {default_ms:.4f} ms (in turns), plain bf16 "
                f"{plain_ms:.4f} ms, no library call, bound {bound_ms:.4f} ms "
                f"({bound_by}; {100 * bound_ms / ms:.1f}% reached), on {card}")
            entries["ssd_bf16"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=None)
        del args, y32, y16, y1, y2, st1, st32

    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    worst_bwd = 0.0
    for name, b, s, h, p, g, n in SSD_KNOB_BWD_CASES:
        args = ssd_inputs(gen, b, s, h, p, g, n)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(bf16)
        got = [ssd_chunked_bwd_kernel_bf16(*args, dy) for _ in range(2)]
        two = ssd_chunked_bwd_kernel(*args, dy)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*got))
        g32 = ssd_backward_reference(*args, dy, chunk=256)
        g16 = ssd_backward_reference(*args, dy, chunk=256, compute_dtype=bf16)
        errs, gates, apart = [], [], 0.0
        for k1, k2, r16, r32 in zip(got[0], two, g16, g32):
            ref_err = row(r16, r32)
            errs.append(row(k1, r32))
            gates.append(max(SSD_KNOB_BUDGET * ref_err, GRAD_ROW_RTOL))
            apart = max(apart, row(k1, k2))
            worst_bwd = max(worst_bwd, (k1.float() - r32).abs().max().item())
        ok = same and apart > SSD_Y_ROW_RTOL and all(
            math.isfinite(e) and e <= t for e, t in zip(errs, gates))
        budget = max([budget] + gates)
        if not ok:
            failed.append(f"ssd_bwd {name}")
        say("ssd knobs", f"ssd_bwd_bf16 {name} B={b} S={s} H={h} P={p} G={g} "
            f"N={n}: worst row against plain fp32 " + ", ".join(
                f"{k} {e:.3e} (gate {t:.3e})"
                for k, e, t in zip(names, errs, gates))
            + f"; against the default instance {apart:.3e} (must exceed "
            f"{SSD_Y_ROW_RTOL}); two calls bit-equal: {same} "
            f"{'ok' if ok else 'FAIL'}")
        del got, two, g32, g16
        if name == "train":
            ms, default_ms = turns(
                lambda: ssd_chunked_bwd_kernel(*args, dy),
                lambda: ssd_chunked_bwd_kernel_bf16(*args, dy), 10)
            plain_ms = cuda_ms(lambda: ssd_backward_reference(
                *args, dy, chunk=256, compute_dtype=bf16), iters=2, warmup=1)
            bound_ms, bound_by = ssd_bwd_bound(b, s, h, p, g, n)
            say("ssd knobs", f"ssd_bwd_bf16 {name}: {ms:.4f} ms, the default "
                f"instance {default_ms:.4f} ms (in turns), plain bf16 "
                f"{plain_ms:.4f} ms, library: none, bound {bound_ms:.4f} ms "
                f"({bound_by}; {100 * bound_ms / ms:.1f}% reached), on {card}")
            entries["ssd_bwd_bf16"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by, library_ms=None)
        del args, dy
    if failed:
        fail("ssd knobs", f"bf16-intra instances outside their gates: "
             f"{failed}")
    say("ssd knobs", f"the phase's bf16 budget: {budget:.3e}")
    fwd = {"name": "ssd_bf16", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd.cu",
           "replaces": "src/repro/kernels/ssd.py:27", "launches": None,
           "max_abs_err": worst, **entries["ssd_bf16"]}
    bwd = {"name": "ssd_bwd_bf16", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_bwd.cu",
           "replaces": "src/repro/models/ssm.py:37", "launches": None,
           "max_abs_err": worst_bwd, **entries["ssd_bwd_bf16"]}
    return fwd, bwd, budget


def phase_ssd_knobs_model(card: str, budget: float) -> dict:
    """mamba2-370m at full width under Rules(ssd_compute_dtype="bfloat16")
    beside the default rules, on the same weights: a prefill of
    KNOB_PREFILL (bf16) and the first training step's gradients (fp32
    masters) held to the default path's within the kernel phase's
    ``budget`` by the worst row (floored at GRAD_ROW_FLOOR); then
    KNOB_TRAIN_STEPS AdamW steps under the knob. The launches must be the
    default path's, on the bf16-intra instances: one forward a layer a
    prefill; two forwards (remat) and a backward a layer a step. Returns
    the bf16-intra instances' launches over the prefill and the steps."""
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import flat_with_names
    from repro_torch.configs import get_config
    from repro_torch.data.loader import Loader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, tree_map
    from repro_torch.sharding.rules import single_device_rules
    from repro_torch.train.step import (init_train_state, loss_and_grads,
                                        make_train_step)

    free_card()
    cfg = get_config(MAMBA)
    layers = cfg.num_layers
    knob = Model(cfg, single_device_rules(ssd_compute_dtype="bfloat16"),
                 device="cuda")
    plain = Model(cfg, device="cuda")
    counters = launch_counters()

    def counted(fn, want: dict, what: str):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        full = dict(dict.fromkeys(counters, 0), **want)
        if counts != full:
            fail("ssd knobs", f"{MAMBA} {what}: launches {counts}, expected "
                 f"{full}")
        return out, counts

    b, s = KNOB_PREFILL
    params = knob.init(torch.Generator(device="cuda").manual_seed(0))
    unembed = knob.unembed_table(params)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    with torch.no_grad():
        ref, _ = counted(lambda: plain.prefill(
            params, {"tokens": toks}, cache_len=CACHE_LEN,
            unembed=unembed)[0], {"ssd": layers}, "default prefill")
        t0 = time.perf_counter()
        logits, prefill_counts = counted(lambda: knob.prefill(
            params, {"tokens": toks}, cache_len=CACHE_LEN,
            unembed=unembed)[0], {"ssd_bf16": layers}, "prefill")
        prefill_s = time.perf_counter() - t0
    row = row_rel_err(logits, ref, floor=GRAD_ROW_FLOOR)
    ok = bool(torch.isfinite(logits).all()) and row <= budget
    say("ssd knobs", f"{MAMBA} prefill B={b} S={s} under the knob: "
        f"{prefill_counts['ssd_bf16']} bf16-intra launches ({layers} layers), "
        f"{1e3 * prefill_s:.1f} ms; logits' worst row against the default "
        f"path's {row:.3e} (the phase's budget {budget:.3e}) "
        f"{'ok' if ok else 'FAIL'}, on {card}")
    if not ok:
        fail("ssd knobs", f"{MAMBA} prefill under the knob: row {row:.3e}")
    del params, unembed, logits, ref

    bsz = TRAIN_BATCHES[MAMBA]
    state = init_train_state(knob, torch.Generator(device="cuda").manual_seed(0))
    params, opt = state.params, state.opt
    loader = Loader(SyntheticStream(cfg.vocab_size, 0), bsz, TRAIN_SEQ, "cuda")
    batch = loader(0)
    grads = {}
    loss = loss_launches(cfg, bsz, TRAIN_SEQ)
    for name, model, want in (
            ("default", plain, {"ssd": 2 * layers, "ssd_bwd": layers,
                                **loss}),
            ("knob", knob, {"ssd_bf16": 2 * layers, "ssd_bwd_bf16": layers,
                            **loss})):
        grads[name] = tree_map(torch.zeros_like, params)
        counted(lambda: loss_and_grads(model, params, batch, grads[name]),
                want, f"{name} first step's gradients")
    errs = {name: row_rel_err(a, r, floor=GRAD_ROW_FLOOR)
            for (name, a), (_, r) in zip(flat_with_names(grads["knob"]),
                                         flat_with_names(grads["default"]))}
    ok = all(math.isfinite(e) and e <= budget for e in errs.values())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    say("ssd knobs", f"{MAMBA} first step B={bsz} S={TRAIN_SEQ}: the "
        f"gradient leaves' worst row against the default path's, the "
        f"largest four of {len(errs)}: "
        + ", ".join(f"{k} {e:.3e}" for k, e in top)
        + f" (the phase's budget {budget:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("ssd knobs", f"{MAMBA} gradients under the knob: {errs}")
    del grads
    step_fn = make_train_step(knob, AdamWConfig(lr=TRAIN_LR))
    total, losses, times = {}, [], []
    for step in range(KNOB_TRAIN_STEPS):
        data = loader(step)
        t0 = time.perf_counter()
        (params, opt, metrics), counts = counted(
            lambda: step_fn(params, opt, data),
            {"ssd_bf16": 2 * layers, "ssd_bwd_bf16": layers, **loss},
            f"step {step}")
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if not all(math.isfinite(x) for x in losses):
        fail("ssd knobs", f"{MAMBA} non-finite loss under the knob: {losses}")
    say("ssd knobs", f"{MAMBA} {KNOB_TRAIN_STEPS} steps B={bsz} S={TRAIN_SEQ}"
        f" under the knob: loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms; bf16-intra "
        f"launches a step {2 * layers} forward, {layers} backward, on {card}")
    del params, opt, state, step_fn
    free_card()
    return {"ssd_bf16": prefill_counts["ssd_bf16"],
            "ssd_bwd_bf16": total["ssd_bwd_bf16"]}


def ptxas_entries(log: str) -> dict:
    """ptxas's report by kernel entry (mangled name): [registers, bytes of
    spill stores]."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            out[name] = [None, None]
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name is not None and spill:
            out[name][1] = int(spill.group(1))
        if name is not None and regs:
            out[name][0] = int(regs.group(1))
    return out


def instance_ptxas(entries: dict, pattern: str) -> tuple:
    """(registers, spill bytes) of the one entry whose name matches."""
    found = [v for k, v in entries.items() if re.search(pattern, k)]
    if len(found) != 1:
        fail("tune kernels", f"{len(found)} ptxas entries match {pattern}")
    return tuple(found[0])


def phase_tune_kernels(card: str) -> None:
    """Every compiled launch config of the two forward kernels at the main
    paths' shapes (TUNE_FLASH_SHAPES, TUNE_SSD_SHAPES), each held to its
    plain version by [kernels]' row gates before it is timed; beside its
    time its share of the bound, ptxas's registers and spills (a spilling
    instance fails), its shared memory, the roofline's predicted time and
    rank among the shape's instances (repro_torch/tune/prune.py) and, for
    flash, SDPA's time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ssd
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels.ref import (attention_reference, row_rel_err,
                                         ssd_chunked_reference)
    from repro_torch.tune import prune

    entries = ptxas_entries(build.build().ptxas_log)
    gen = torch.Generator(device="cuda").manual_seed(3)
    failed = []

    def ranks(kernel, configs, shape):
        pred = {c: prune.predict_seconds(kernel, dict(c), **shape)
                for c in configs}
        order = sorted(pred, key=pred.get)
        return {c: (1e3 * pred[c], order.index(c) + 1) for c in pred}

    def report(what, cfg, default, gate, ms, bound, ptx, smem, pred, extra):
        ok = gate[0] and ptx[1] == 0
        if not ok:
            failed.append(f"{what} {cfg}")
        say("tune kernels", f"{what} {cfg}{' (default)' if default else ''}: "
            f"{gate[1]}; {ms:.4f} ms ({100 * bound[0] / ms:.1f}% of the "
            f"{bound[0]:.4f} ms bound, {bound[1]}){extra}; ptxas {ptx[0]} "
            f"registers, {ptx[1]} bytes spilled; {smem} bytes of shared "
            f"memory a block; predicted {pred[0]:.4f} ms, rank {pred[1]} of "
            f"the shape's instances; {'ok' if ok else 'FAIL'}, on {card}")

    for name, b, s, hq, hkv, d, window in TUNE_FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for h in (hq, hkv, hkv))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ref = attention_reference(qt, kt, vt, causal=True,
                                  window=window).transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        configs = [dict(block_q=bq, block_k=bk) for bq, bk in flash.CONFIGS[d]]
        pred = ranks("flash_attention", [tuple(c.items()) for c in configs],
                     dict(b=b, hq=hq, hkv=hkv, sq=s, sk=s, d=d, window=window))
        bound = attention_bound(b, hq, hkv, s, d)
        for cfg in configs:
            run = lambda: flash.flash_attention(q, k, v, causal=True,  # noqa: E731
                                                window=window, **cfg)
            row = row_rel_err(run(), ref)
            ok = math.isfinite(row) and row <= KERNEL_ROW_RTOL
            ms = cuda_ms(run, iters=20) if ok else math.nan
            kname = "flash_fwd_kernel" if cfg["block_q"] == 128 else \
                "flash_fwd_q64_kernel"
            report(f"flash_attention {name} B={b} S={s} Hq={hq} Hkv={hkv} "
                   f"D={d} window={window}", (cfg["block_q"], cfg["block_k"]),
                   (cfg["block_q"], cfg["block_k"]) == flash.DEFAULT_CONFIG,
                   (ok, f"worst row rel L2 err {row:.3e} (tol "
                    f"{KERNEL_ROW_RTOL})"), ms, bound,
                   instance_ptxas(entries, f"{kname}ILi{d}ELi{cfg['block_k']}EE"),
                   flash.shared_memory_bytes(d, cfg["block_q"], cfg["block_k"]),
                   pred[tuple(cfg.items())],
                   f", {attention_flops(b, hq, s, d) / ms / 1e9:.1f} TFLOP/s, "
                   f"SDPA {sdpa_ms:.4f} ms")
        del q, k, v, qt, kt, vt, ref
    for name, b, s, h, p, g, n in TUNE_SSD_SHAPES:
        args = ssd_inputs(gen, b, s, h, p, g, n)
        y_ref, st_ref = ssd_chunked_reference(*args, chunk=256)
        pred = ranks("ssd", [(("chunk", c),) for c in ssd.CONFIGS[n]],
                     dict(b=b, s=s, h=h, p=p, g=g, n=n))
        bound = ssd_bound(b, s, h, p, g, n)
        for chunk in ssd.CONFIGS[n]:
            run = lambda: ssd.ssd_chunked_kernel(*args, chunk=chunk)  # noqa: E731
            y, st = run()
            y_row, st_row = row_rel_err(y, y_ref), row_rel_err(st, st_ref)
            ok = (math.isfinite(y_row) and y_row <= SSD_Y_ROW_RTOL
                  and math.isfinite(st_row) and st_row <= SSD_STATE_ROW_RTOL)
            ms = cuda_ms(run, iters=20) if ok else math.nan
            report(f"ssd {name} B={b} S={s} H={h} P={p} G={g} N={n}", chunk,
                   chunk == ssd.TILE,
                   (ok, f"y worst row rel L2 err {y_row:.3e} (tol "
                    f"{SSD_Y_ROW_RTOL}), final state {st_row:.3e} (tol "
                    f"{SSD_STATE_ROW_RTOL})"), ms, bound,
                   instance_ptxas(entries, f"ssd_fwd_kernelILi{p}ELi{n}ELi"
                                           f"{chunk}ELi2EE"),
                   ssd.shared_memory_bytes(p, n, chunk),
                   pred[(("chunk", chunk),)],
                   f", {ssd_flops(b, s, h, p, g, n, tile=chunk) / ms / 1e9:.1f}"
                   " TFLOP/s, no library call")
        del args, y_ref, st_ref
    if failed:
        fail("tune kernels", f"instances that disagree with plain or spill: "
             f"{failed}")


def tune_workloads() -> list:
    """The boot's sweep: every TUNE_*_SHAPES shape, bf16 on the card."""
    return ([{"kernel": "flash_attention", "b": b, "hq": hq, "hkv": hkv,
              "sq": s, "d": d, "window": window, "repeats": TUNE_REPEATS}
             for _, b, s, hq, hkv, d, window in TUNE_FLASH_SHAPES]
            + [{"kernel": "ssd", "b": b, "s": s, "h": h, "p": p, "g": g,
                "n": n, "repeats": TUNE_REPEATS}
               for _, b, s, h, p, g, n in TUNE_SSD_SHAPES])


def phase_tune_boot(card: str):
    """Two boots of a one-node job through BootseerRuntime(tune=True) with
    the production shapes as its tune workloads, in build/tune-boot-*
    (deleted after): the first sweeps the compiled configs on the card and
    publishes the profile, the second fetches it with no sweep. Returns the
    profile; no profile stays active afterwards."""
    import numpy as np
    from repro_torch.blockstore.image import build_image
    from repro_torch.blockstore.registry import Registry
    from repro_torch.core.bootseer import BootseerRuntime, JobSpec
    from repro_torch.dfs.hdfs import HdfsCluster
    from repro_torch.tune.profile import set_active_profile

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tune-boot-", dir=ROOT / "build"))
    try:
        (work / "src" / "bin").mkdir(parents=True)
        (work / "src" / "bin" / "start").write_bytes(
            np.random.default_rng(0).integers(0, 256, 1 << 16,
                                              dtype=np.uint8).tobytes())
        reg = Registry(work / "reg")
        build_image(work / "src", reg, "img", block_size=1 << 16)
        spec = JobSpec(job_id="tune", image="img", num_nodes=1,
                       job_params={"deps": ["kernels"]},
                       startup_reads=[("bin/start", 0, -1)],
                       env_setup=lambda target, rank:
                           (target / "dep.py").write_text("x = 1"))
        runs = []
        with BootseerRuntime(registry=reg, hdfs=HdfsCluster(
                work / "hdfs", num_groups=4, block_size=1 << 20),
                workdir=work / "rt", tune=True,
                tune_workloads=tune_workloads()) as rt:
            for _ in range(2):
                t0 = time.perf_counter()
                notes = rt.run_startup(spec).notes
                rt.drain_deferred()
                runs.append((notes, time.perf_counter() - t0))
            profile = rt.tune_store.fetch()
            publishes = rt.tune_store.stats["publishes"]
    finally:
        # later phases run the defaults unless they name the profile
        set_active_profile(None)
        shutil.rmtree(work, ignore_errors=True)
    for boot, (notes, wall) in zip(("cold", "warm"), runs):
        say("tune boot", f"{boot} boot: tune_cache_hit "
            f"{notes.get('tune_cache_hit')}, tune_invocations "
            f"{notes.get('tune_invocations')}, digest "
            f"{notes.get('tune_profile_digest', '')[:16]}, tune_error "
            f"{notes.get('tune_error')}; {wall:.1f} s with the join")
    (cold, _), (warm, _) = runs
    n_wl = len(tune_workloads())
    if (cold.get("tune_cache_hit") is not False
            or cold.get("tune_invocations") != n_wl or "tune_error" in cold):
        fail("tune boot", f"the cold boot did not sweep its {n_wl} "
             "workloads cleanly")
    if (warm.get("tune_cache_hit") is not True
            or warm.get("tune_invocations") != 0 or "tune_error" in warm
            or warm.get("tune_profile_digest")
            != cold.get("tune_profile_digest") or publishes != 1
            or profile is None or profile.digest()
            != cold.get("tune_profile_digest")):
        fail("tune boot", "the warm boot did not fetch the cold boot's "
             "profile with 0 invocations")
    say("tune boot", f"the warm boot fetched the profile with 0 invocations "
        f"({publishes} publish); backend {profile.backend}")
    for key, entry in sorted(profile.entries.items()):
        say("tune boot", f"{key}: winner {entry['config']}, "
            f"{1e3 * entry['measured_s']:.4f} ms against the default's "
            f"{1e3 * entry['default_s']:.4f} ms "
            f"({entry['default_s'] / entry['measured_s']:.3f}x), "
            f"{entry['measured']} of {entry['candidates']} candidates "
            f"measured, on {card}")
    return profile


def unembed_ce_inputs(gen, rows: int, d: int, vocab: int, dtype, tied: bool):
    """h [rows, d] ~ N(0, 1), as the final norm's output; the table [d, V]
    ~ N(0, 0.05^2) (tied: a transposed view of a [V, d] embedding); labels
    uniform over the vocabulary, int32."""
    import torch
    h = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    shape = (vocab, d) if tied else (d, vocab)
    table = (0.05 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda",
                           dtype=torch.int32)
    return h, table.t() if tied else table, labels


def peak_rise(fn) -> float:
    """The bytes ``fn()`` adds to the card's peak over what it holds."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_unembed_ce_kernels(card: str) -> tuple[dict, dict]:
    """The training loss's vocab-chunked operator (kernels/unembed_ce.py)
    at UNEMBED_CE_CASES: each kernel against its plain version on the
    case's own chunks (the fold over every chunk: log-sum-exp and label
    logits; the gradient pass on the first: fp32 g, and its planes exact
    to it), then the operator's loss, dh and dW against its plain version
    by the row gates, one launch of each kernel per chunk, and the peak it
    adds: its backward workspace and the two gradients, nothing beside.
    At the cell's shape, each kernel's time on one chunk beside its plain
    version's, the library's (logsumexp for the fold) and its bound, the
    chunk's three products, and the operator's forward + backward beside
    its bound, its plain version and the fp32 composition it replaced,
    with the peak each adds. Returns the two kernels' kernels-line
    entries."""
    import torch
    from repro_torch.kernels.ops import unembed_ce_chunked
    from repro_torch.kernels.ref import (ce_fold_reference,
                                         ce_grad_reference, row_rel_err)
    from repro_torch.kernels.unembed_ce import (
        ce_fold_kernel, ce_grad_kernel, unembed_ce_plain,
        unembed_ce_workspace_floats, vocab_chunk)
    from repro_torch.roofline.kernel_cost import (
        ce_fold_bound, ce_grad_bound, unembed_ce_bound)

    gen = torch.Generator(device="cuda").manual_seed(3)
    dce = torch.tensor(0.7, device="cuda")
    failed = []
    for name, rows, d, vocab, dname, tied in UNEMBED_CE_CASES:
        dtype = getattr(torch, dname)
        bf16 = dtype == torch.bfloat16
        h, table, labels = unembed_ce_inputs(gen, rows, d, vocab, dtype, tied)
        vc = vocab_chunk(rows, d, vocab, dtype)
        chunks = -(-vocab // vc)

        def product(v0, v1):
            w_c = table[:, v0:v1]
            return (torch.mm(h, w_c, out_dtype=torch.float32) if bf16
                    else torch.mm(h, w_c))

        state, ref_state = (torch.empty((3, rows), device="cuda")
                            for _ in range(2))
        lse, ref_lse = (torch.empty(rows, device="cuda") for _ in range(2))
        for v0 in range(0, vocab, vc):
            v1 = min(v0 + vc, vocab)
            logits = product(v0, v1)
            ce_fold_kernel(logits, labels, v0, state, lse, first=v0 == 0,
                           last=v1 == vocab)
            ce_fold_reference(logits, labels, v0, ref_state, ref_lse,
                              first=v0 == 0, last=v1 == vocab)
        lse_err = (lse - ref_lse).abs().max().item()
        picked = torch.equal(state[2], ref_state[2])
        logits = product(0, vc)
        g = ce_grad_kernel(logits.clone(), labels, 0, lse, dce)
        g_err = row_rel_err(g, ce_grad_reference(logits.clone(), labels, 0,
                                                 lse, dce))
        exact = True
        if bf16:
            planes = torch.empty((rows, 3, vc), dtype=torch.bfloat16,
                                 device="cuda")
            ce_grad_kernel(logits, labels, 0, lse, dce, planes=planes)
            exact = torch.equal(planes.double().sum(dim=1), g.double())
            del planes
        del logits, g, state, ref_state, ref_lse

        hv = h.clone().requires_grad_()
        tv = table.clone().requires_grad_()
        ws = 4 * unembed_ce_workspace_floats(rows, d, vocab, dtype, vc,
                                             backward=True)
        grads = (rows * d + d * vocab) * dtype.itemsize
        out = {}

        def op():
            out["loss"] = unembed_ce_chunked(hv, tv, labels, vc)
            (out["loss"] * dce).backward()

        op()   # autograd's thread takes its cuBLAS workspace here, once
        hv.grad = tv.grad = None
        f0, g0 = ce_fold_kernel.launches, ce_grad_kernel.launches
        rise = peak_rise(op)
        launches = (ce_fold_kernel.launches - f0,
                    ce_grad_kernel.launches - g0)
        ref_loss, ref_dh, ref_dt = unembed_ce_plain(h, table, labels, dce,
                                                    vc)
        loss_err = abs(out["loss"].item() / ref_loss.item() - 1)
        dh_err = row_rel_err(hv.grad, ref_dh, floor=GRAD_ROW_FLOOR)
        dw_err = row_rel_err(tv.grad.t(), ref_dt.t(), floor=GRAD_ROW_FLOOR)
        tol = UNEMBED_CE_ROW_RTOL if bf16 else UNEMBED_CE_FP32_ROW_RTOL
        ok = (lse_err <= CE_LSE_ABS_TOL and picked
              and g_err <= CE_GRAD_ROW_RTOL and exact
              and loss_err <= UNEMBED_CE_LOSS_RTOL
              and dh_err <= tol and dw_err <= tol
              and launches == (chunks, chunks)
              and tv.grad.stride() == table.stride()
              and ws <= rise <= ws + grads + (4 << 20))
        if not ok:
            failed.append(name)
        say("kernels", f"unembed_ce {name} T={rows} d={d} V={vocab} {dname}"
            f"{' tied' if tied else ''}, {chunks} chunks of {vc}: "
            f"ce_fold lse max abs err {lse_err:.3e} (tol {CE_LSE_ABS_TOL}), "
            f"label logits bit-equal {picked}; ce_grad g worst row "
            f"{g_err:.3e} (tol {CE_GRAD_ROW_RTOL}), planes sum to g "
            f"exactly {exact}; operator: loss rel err {loss_err:.3e} (tol "
            f"{UNEMBED_CE_LOSS_RTOL}), dh worst row {dh_err:.3e}, dW "
            f"{dw_err:.3e} (tol {tol:.3e}, floor {GRAD_ROW_FLOOR} x "
            f"median); launches fold/grad {launches[0]}/{launches[1]} "
            f"(want {chunks}); peak rise {rise / 1e9:.3f} GB = the "
            f"backward's workspace {ws / 1e9:.3f} GB + the gradients "
            f"{grads / 1e9:.3f} GB (+ 4 MiB) at most "
            f"{'ok' if ok else 'FAIL'}")
        del h, table, labels, hv, tv, out, ref_dh, ref_dt
    if failed:
        fail("kernels", f"unembed_ce disagrees with plain: {failed}")

    _, rows, d, vocab, _, _ = UNEMBED_CE_CASES[0]
    h, table, labels = unembed_ce_inputs(gen, rows, d, vocab, torch.bfloat16,
                                         False)
    vc = vocab_chunk(rows, d, vocab, torch.bfloat16)
    hv = h.clone().requires_grad_()
    tv = table.clone().requires_grad_()

    def op():
        hv.grad = tv.grad = None
        unembed_ce_chunked(hv, tv, labels, vc).backward()

    def op_forward():
        with torch.no_grad():
            unembed_ce_chunked(h, table, labels, vc)

    def composition():
        hv.grad = tv.grad = None
        logits = hv.float() @ tv.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.long()[:, None])[:, 0]
        (lse - picked).mean().backward()

    timed = {}
    for what, fn, iters in (("op", op, 10), ("forward", op_forward, 10),
                            ("plain", lambda: unembed_ce_plain(
                                h, table, labels, dce, vc), 2),
                            ("composition", composition, 5)):
        ms = cuda_ms(fn, iters=iters, warmup=1)
        hv.grad = tv.grad = None
        timed[what] = (ms, peak_rise(fn))
    bound_ms, bound_by = unembed_ce_bound(rows, d, vocab)
    flops = 16 * rows * d * vocab
    say("kernels", f"unembed_ce cell T={rows} d={d} V={vocab}, {vc}-column "
        f"chunks: forward + backward {timed['op'][0]:.3f} ms (forward "
        f"{timed['forward'][0]:.3f}; {flops / timed['op'][0] / 1e9:.1f} "
        f"TFLOP/s of its own {flops / 1e12:.2f} TFLOP), bound "
        f"{bound_ms:.3f} ms ({bound_by}, bf16 tensor cores; "
        f"{100 * bound_ms / timed['op'][0]:.1f}% reached); plain "
        f"{timed['plain'][0]:.3f} ms; library: the fp32 composition it "
        f"replaced {timed['composition'][0]:.3f} ms; peak rise "
        f"{timed['op'][1] / 1e9:.3f} GB (composition "
        f"{timed['composition'][1] / 1e9:.3f} GB, plain "
        f"{timed['plain'][1] / 1e9:.3f} GB), on {card}")

    # one full chunk: its product, each kernel, the two plane products
    w_c = table[:, :vc]
    logits = torch.mm(h, w_c, out_dtype=torch.float32)
    state = torch.empty((3, rows), device="cuda")
    lse = torch.logsumexp(logits, dim=-1)
    planes = torch.empty((rows, 3, vc), dtype=torch.bfloat16, device="cuda")
    ce_grad_kernel(logits, labels, 0, lse, dce, planes=planes)
    w3 = w_c.t().repeat(3, 1)
    h3 = h.repeat_interleave(3, dim=0)
    chunk_flops = 2 * rows * d * vc
    for what, fn, flops in (
            ("logits product", lambda: torch.mm(h, w_c,
                                                out_dtype=torch.float32),
             chunk_flops),
            ("dh product", lambda: torch.mm(planes.view(rows, 3 * vc), w3,
                                            out_dtype=torch.float32),
             3 * chunk_flops),
            ("dW product", lambda: torch.mm(h3.t(), planes.view(3 * rows, vc),
                                            out_dtype=torch.float32),
             3 * chunk_flops)):
        ms = cuda_ms(fn, iters=10)
        say("kernels", f"unembed_ce cell, one chunk of {vc}: {what} "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, bf16 operands, "
            f"fp32 accumulation and output), on {card}")
    entries = []
    for name, fn, plain, library, (bound_ms, bound_by) in (
            ("ce_fold",
             lambda: ce_fold_kernel(logits, labels, 0, state, lse,
                                    first=True, last=False),
             lambda: ce_fold_reference(logits, labels, 0, state, lse,
                                       first=True, last=False),
             lambda: torch.logsumexp(logits, dim=-1),
             ce_fold_bound(rows, vc)),
            ("ce_grad",
             lambda: ce_grad_kernel(logits, labels, 0, lse, dce,
                                    planes=planes),
             lambda: ce_grad_reference(logits, labels, 0, lse, dce,
                                       planes=planes),
             None, ce_grad_bound(rows, vc))):
        ms = cuda_ms(fn, iters=20)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        library_ms = None if library is None else cuda_ms(library, iters=10)
        say("kernels", f"{name} cell, one chunk T={rows} x {vc}: {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, library "
            + ("none" if library_ms is None
               else f"(logsumexp) {library_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.1f}% reached), on {card}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/unembed_ce.cu",
            "replaces": "src/repro/models/model.py:643", "launches": None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    del h, table, labels, hv, tv, logits, planes, w3, h3
    free_card()
    return tuple(entries)


def config_launches() -> dict:
    """The forward kernels' launches by launch config, as the kernels line
    names them."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked_kernel
    return {"flash_attention": {f"{bq}x{bk}": n for (bq, bk), n in sorted(
                flash_attention.config_launches.items())},
            "ssd": {str(c): n for c, n in sorted(
                ssd_chunked_kernel.config_launches.items())}}


def reset_launches() -> dict:
    """Every kernel wrapper's counts set to 0; returns the wrappers."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for name in ("flash_attention", "ssd"):
        counters[name].config_launches = {}
    return counters


def tuned_configs(cfg, profile, s: int) -> dict:
    """The configs, as config_launches names them, that the profile gives
    ``cfg``'s forward kernels at sequence length ``s`` (the default where
    it has no entry, or with no profile)."""
    from repro_torch.kernels.ops import card_backend
    from repro_torch.tune import autotune
    from repro_torch.tune.profile import attention_key, ssd_key
    entries = {} if profile is None else profile.entries
    out = {}
    if cfg.num_heads:
        key = attention_key(sq=s, sk=s, d=cfg.head_dim,
                            g=cfg.num_heads // cfg.num_kv_heads,
                            dtype="bfloat16", causal=True,
                            window=cfg.sliding_window or 0,
                            backend=card_backend())
        c = entries.get(key, {}).get(
            "config", autotune.DEFAULT_CARD_ATTENTION)
        out["flash_attention"] = f"{c['block_q']}x{c['block_k']}"
    if cfg.ssm:
        heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        key = ssd_key(s=s, h=heads, p=cfg.ssm.head_dim, g=cfg.ssm.ngroups,
                      n=cfg.ssm.state_dim, dtype="bfloat16",
                      backend=card_backend())
        out["ssd"] = str(entries.get(key, {}).get(
            "config", autotune.DEFAULT_CARD_SSD)["chunk"])
    return out


def serve_tuned(card: str, arch: str, model, params, toks, unembed,
                profile) -> None:
    """One prefill under the tuned profile against one on the default
    configs: the launch counts exact in both (a launch per attention call
    and Mamba2 layer, each at the profile's config for the shape), the
    logits held to the default run's by the logits' row gate
    (REFERENCE_ROW_RTOL), and the prefill's time both ways, timed in turns
    (default, tuned, tuned, default)."""
    import torch
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.tune.profile import use_profile

    def prefill():
        return model.prefill(params, {"tokens": toks}, cache_len=CACHE_LEN,
                             unembed=unembed)[0]

    want = dict.fromkeys(launch_counters(), 0)
    want.update(prefill_launches(model.cfg))
    runs, ms = {}, {"default": [], "tuned": []}
    for way, prof in (("default", None), ("tuned", profile)):
        with use_profile(prof), torch.no_grad():
            counters = reset_launches()
            logits = prefill().float()
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in counters.items()}
            by_config = config_launches()
        if counts != want:
            fail("serve", f"{arch} {way}: kernel launches {counts}, expected "
                 f"{want}")
        runs[way] = logits, by_config
    for way in ("default", "tuned", "tuned", "default"):
        with use_profile(profile if way == "tuned" else None), \
                torch.no_grad():
            ms[way].append(cuda_ms(prefill, iters=3, warmup=1))
    b, s = toks.shape
    picked = tuned_configs(model.cfg, profile, s)
    expect = {k: ({picked[k]: n} if n else {})
              for k, n in (("flash_attention", want["flash_attention"]),
                           ("ssd", want["ssd"]))}
    row = row_rel_err(runs["tuned"][0], runs["default"][0])
    ok = (math.isfinite(row) and row <= REFERENCE_ROW_RTOL
          and runs["tuned"][1] == expect)
    say("serve", f"{arch} prefill B={b} S={s} under the tuned profile: "
        f"launches by config {runs['tuned'][1]} (the profile's {picked}; "
        f"default run {runs['default'][1]}); logits' worst row rel L2 err "
        f"against the default configs {row:.3e} (tol {REFERENCE_ROW_RTOL}); "
        f"prefill {', '.join(f'{t:.2f}' for t in ms['tuned'])} ms tuned, "
        f"{', '.join(f'{t:.2f}' for t in ms['default'])} ms default (in "
        f"turns: default, tuned, tuned, default); {'ok' if ok else 'FAIL'}, "
        f"on {card}")
    if not ok:
        fail("serve", f"{arch}: the tuned prefill disagrees with the default")


def launch_counters() -> dict:
    """Every kernel wrapper, by the name the kernels line gives it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
    from repro_torch.kernels.ssd import (
        ssd_chunked_bwd_kernel, ssd_chunked_bwd_kernel_bf16,
        ssd_chunked_kernel, ssd_chunked_kernel_bf16)
    from repro_torch.kernels.unembed_ce import ce_fold_kernel, ce_grad_kernel
    return {"flash_attention": flash_attention, "ssd": ssd_chunked_kernel,
            "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_bwd_deterministic":
                flash_attention_bwd_deterministic,
            "ssd_bwd": ssd_chunked_bwd_kernel,
            "ssd_bf16": ssd_chunked_kernel_bf16,
            "ssd_bwd_bf16": ssd_chunked_bwd_kernel_bf16,
            "ce_fold": ce_fold_kernel, "ce_grad": ce_grad_kernel}


class Routes:
    """Within ``with``: every MoE router call's (probs, expert ids), copied
    to the CPU, by wrapping ``repro_torch.models.moe.router_topk``. With
    ``force``, expert ids [T, k] per layer, each call is routed to them
    instead, the gates renormalised from its own probabilities: a training
    forward and backward under remat calls the router once per layer,
    then once per layer last first."""

    def __init__(self, force=None):
        self.force, self.calls = force, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.mod, inner = moe, moe.router_topk
        n = len(self.force or ())

        def wrapped(x32, router_w, k):
            probs, gate, idx = inner(x32, router_w, k)
            if self.force:
                c = len(self.calls) % (2 * n)
                idx = self.force[c if c < n else 2 * n - 1 - c].to(
                    probs.device)
                gate = probs.gather(1, idx)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            self.calls.append((probs.detach().float().cpu(), idx.cpu()))
            return probs, gate, idx

        self.inner, moe.router_topk = inner, wrapped
        return self

    def __exit__(self, *exc):
        self.mod.router_topk = self.inner


def flipped_tokens(ref_calls, calls, k: int):
    """The tokens of one step (its layers' router calls) whose expert set
    differs from the reference's, [T] bool, and the first flips' margins
    (p_k - p_(k+1)) / p_k on the reference's side; fails if a first flip
    lies past FLIP_MARGIN."""
    import torch
    flipped, margins = None, []
    for (rp, ri), (_, gi) in zip(ref_calls, calls, strict=True):
        diff = (ri.sort(-1).values != gi.sort(-1).values).any(-1)
        flipped = torch.zeros_like(diff) if flipped is None else flipped
        top = rp.sort(-1, descending=True).values
        margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        first = diff & ~flipped
        margins += margin[first].tolist()
        flipped |= diff
    if any(m > FLIP_MARGIN for m in margins):
        fail("reference", f"a token took other experts on the card at a "
             f"margin past {FLIP_MARGIN}: margins {margins}")
    return flipped, margins


def prefill_launches(cfg) -> dict:
    """Each forward kernel's launches in one prefill (or one training
    forward) of ``cfg``: the flash forward once per attention call (a
    layer each in the dense, MoE and frontend families, the ceil(L /
    every) calls of the hybrid's shared block), the SSD forward once per
    Mamba2 layer."""
    from repro_torch.models.model import TRANSFORMER_ARCH_TYPES
    calls = 0
    if cfg.arch_type in TRANSFORMER_ARCH_TYPES:
        calls = cfg.num_layers
    elif cfg.arch_type == "hybrid":
        calls = -(-cfg.num_layers // cfg.shared_attention_every)
    return {"flash_attention": calls,
            "ssd": cfg.num_layers if cfg.ssm else 0}


def loss_launches(cfg, b: int, s: int) -> dict:
    """The loss kernels' launches in one training step of ``cfg`` at B =
    ``b`` x S = ``s`` on one card: the fold and the gradient pass once per
    vocabulary chunk (the width from the shapes alone)."""
    import torch
    from repro_torch.kernels.unembed_ce import vocab_chunk
    chunk = vocab_chunk(b * s, cfg.d_model, cfg.vocab_size,
                        getattr(torch, cfg.dtype))
    n = -(-cfg.vocab_size // chunk)
    return {"ce_fold": n, "ce_grad": n}


def vision_grid_pos(b: int, s: int, grid: tuple, device, start: int = 4):
    """[b, s, 3] int32 M-RoPE positions as Qwen2-VL lays out an image in
    text: ``start`` text tokens (all three streams the token index), the
    image's t x h x w patches at (start + t, start + h, start + w), then
    text going on from the largest position + 1 on all three streams. t,
    h and w differ across the image, so a wrong section split shows."""
    import torch
    n = math.prod(grid)
    tt, hh, ww = torch.meshgrid(*(torch.arange(k) for k in grid),
                                indexing="ij")
    image = start + torch.stack([tt, hh, ww], -1).reshape(n, 3)
    text = torch.arange(start)[:, None].expand(start, 3)
    after = (start + max(grid) + torch.arange(s - start - n))[:, None]
    pos = torch.cat([text, image, after.expand(-1, 3)]).to(torch.int32)
    return pos.expand(b, s, 3).to(device)


def frontend_batch(cfg, b: int, s: int, grid: tuple, generator, device):
    """A frontend family's stand-in inputs: fp32 frame or patch
    embeddings from ``generator`` (on its own device), and with M-RoPE the
    vision-grid positions of an image of ``grid`` patches; on ``device``."""
    from repro_torch.models import frontend
    batch = {"embeddings": frontend.fake_embeddings(
        cfg, b, s, generator, generator.device).to(device)}
    if cfg.mrope:
        batch["mrope_pos"] = vision_grid_pos(b, s, grid, device)
    return batch


def tiny_config(arch: str):
    """The card-vs-CPU checks' config: ``arch`` reduced, with
    TINY_OVERRIDES."""
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch), **TINY_OVERRIDES.get(arch, {}))


def phase_serve(card: str, arch: str, profile=None) -> dict:
    """Serves ``arch`` at full width (at SERVE_LAYERS[arch] layers where
    its weights do not fit the card) from token prompts; returns every
    kernel's launches over the main path, which must be one prefill's
    (``prefill_launches``) and nothing else. ``Model.init``'s peak memory
    must stay within 1 GB of the tree (it draws in parts). An MoE config's
    prefill and decode drop what their capacity does not keep (counted
    here), so its prefill-vs-decode check runs on a copy whose capacity
    factor E/k keeps every token. A config with M-RoPE then runs its
    embeddings path (``serve_vision``). With a tuning ``profile``, a prefill
    under it is held to one on the default configs (``serve_tuned``). The
    counts returned carry the forward kernels' launches by config under
    "configs"."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    free_card()
    cfg = get_config(arch)
    cut = ""
    if arch in SERVE_LAYERS:
        cut = f" (of {cfg.num_layers}: depth cut to fit the card)"
        cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    tree = sum(t.nbytes for t in tree_leaves(params))
    init_extra = torch.cuda.max_memory_allocated() - tree
    say("serve", f"{arch}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{model.count_params() / 1e9:.3f} B params in {cfg.dtype} "
        f"({tree / 1e9:.2f} GB), init {time.perf_counter() - t0:.1f} s, "
        f"init's peak {init_extra / 1e9:.3f} GB above the tree (tol 1 GB)")
    if not init_extra <= 1e9:
        fail("serve", f"Model.init's peak is {init_extra / 1e9:.2f} GB above "
             "its tree")
    engine = ServeEngine(model, params, batch=BATCH, cache_len=CACHE_LEN,
                         device="cuda")

    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, BATCH)
    lens[0] = PROMPT_LENS[1]  # the batch pads to the kernel check's shape
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def make_requests(new_tokens):
        return [Request(prompt=p, max_new_tokens=new_tokens,
                        temperature=0.7 if i % 2 else 0.0)
                for i, p in enumerate(prompts)]

    # warm-up at the same shapes (cuBLAS heuristics, allocator), not counted
    engine.generate(make_requests(2), seed=0)
    requests = make_requests(NEW_TOKENS)

    # every logit the engine samples from is checked after the run
    finite = []
    entry_points = model.prefill, model.decode_step

    def watch(fn):
        def watched(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return watched

    model.prefill, model.decode_step = map(watch, entry_points)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    t0 = time.perf_counter()
    engine.generate(requests, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    configs = config_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model.prefill, model.decode_step = entry_points

    # one prefill for the batch; no other kernel
    want = dict.fromkeys(counters, 0)
    want.update(prefill_launches(cfg))
    if counts != want:
        fail("serve", f"{arch}: kernel launches {counts}, expected {want} "
             f"(one prefill: a flash launch per attention call, an SSD "
             f"launch per Mamba2 layer)")
    launches = ", ".join(f"{k} {n}" for k, n in counts.items() if n)
    if len(finite) != 1 + NEW_TOKENS or not all(bool(f) for f in finite):
        fail("serve", f"non-finite logits in the main path ({len(finite)} "
             "calls watched)")
    n_tok = sum(len(r.generated) for r in requests)
    bad = [t for r in requests for t in r.generated
           if not 0 <= t < cfg.vocab_size]
    if n_tok != BATCH * NEW_TOKENS or bad:
        fail("serve", f"{n_tok} tokens generated, out of range: {bad[:8]}")
    say("serve", f"{arch} generate: {BATCH} requests, prompts {lens.min()}-"
        f"{lens.max()}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, peak memory {peak_gb:.2f} GB, "
        f"launches {launches} (by config {configs}), logits of all "
        f"{len(finite)} prefill/decode calls finite, on {card}")

    # The same batch again through the model's entry points, timed apart.
    plen = int(lens.max())
    toks = np.zeros((BATCH, plen), np.int32)
    for i, r in enumerate(requests):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    unembed = engine.unembed
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: model.prefill(
            params, {"tokens": toks}, cache_len=CACHE_LEN, unembed=unembed),
            iters=3, warmup=1)
        logits, cache = model.prefill(params, {"tokens": toks},
                                      cache_len=CACHE_LEN, unembed=unembed)
        all_finite = bool(torch.isfinite(logits).all())
        nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = model.decode_step(params, nxt, cache, plen + step,
                                              unembed=unembed)
            all_finite &= bool(torch.isfinite(logits).all())
            nxt = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / NEW_TOKENS
    if not all_finite:
        fail("serve", "non-finite logits")
    say("serve", f"{arch} prefill B={BATCH} S={plen}: {prefill_ms:.2f} ms; decode: "
        f"{decode_ms:.2f} ms/step ({BATCH * 1e3 / decode_ms:.1f} tok/s); "
        f"all logits finite, on {card}")
    del cache

    check_model, check_toks = model, toks
    if cfg.moe:
        # what the capacity drops: one prefill and one decode step, routed
        with torch.no_grad(), Routes() as routes:
            _, cache = model.prefill(params, {"tokens": toks},
                                     cache_len=CACHE_LEN, unembed=unembed)
            model.decode_step(params, nxt, cache, plen + NEW_TOKENS,
                              unembed=unembed)
        del cache
        e, k = cfg.moe.num_experts, cfg.moe.experts_per_token
        for what, calls in (("prefill", routes.calls[:cfg.num_layers]),
                            ("decode step", routes.calls[cfg.num_layers:])):
            t = calls[0][1].shape[0]
            cap = moe.capacity_for(t, cfg.moe)
            dropped = sum(int((~moe._dispatch_indices(idx, t, e, cap)[4])
                              .sum()) for _, idx in calls)
            say("serve", f"{arch} {what}: {t} tokens a layer (padding "
                f"included), capacity {cap}: {dropped} of "
                f"{t * k * len(calls)} assignments dropped over "
                f"{len(calls)} layers ({100 * dropped / (t * k * len(calls)):.1f}%)")
        check_model = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=e / k)), device="cuda")
        check_toks = toks[:2]

    # prefill(S) == prefill(S-1) + decode_step(token S-1)
    with torch.no_grad():
        full, _ = check_model.prefill(params, {"tokens": check_toks},
                                      cache_len=CACHE_LEN, unembed=unembed)
        _, cache = check_model.prefill(params, {"tokens": check_toks[:, :-1]},
                                       cache_len=CACHE_LEN, unembed=unembed)
        step, _ = check_model.decode_step(params, check_toks[:, -1:], cache,
                                          plen - 1, unembed=unembed)
    del cache
    rel = ((step - full).norm() / full.norm()).item()
    max_abs = (step - full).abs().max().item()
    ok = math.isfinite(rel) and rel <= CONSISTENCY_RTOL
    nodrop = (f" (B={check_toks.shape[0]}, capacity factor "
              f"{check_model.cfg.moe.capacity_factor:.3f}: nothing dropped)"
              if cfg.moe else "")
    say("serve", f"{arch} prefill(S) vs prefill(S-1)+decode{nodrop}: relative "
        f"L2 {rel:.3e} (tol {CONSISTENCY_RTOL}), max abs {max_abs:.3e}, max "
        f"|logit| {full.abs().max().item():.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("serve", "prefill and decode disagree")

    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks},
                                 cache_len=CACHE_LEN, unembed=unembed)
    windows = {name: profile_window(f"{arch} {name}", fn, card,
                                    scopes=MOE_SCOPES if cfg.moe else ())
               for name, fn in (
        ("prefill", lambda: model.prefill(params, {"tokens": toks},
                                          cache_len=CACHE_LEN,
                                          unembed=unembed)),
        ("decode x4", lambda: [model.decode_step(params, toks[:, -1:],
                                                 cache, plen + i,
                                                 unembed=unembed)
                               for i in range(4)]))}
    roofline_serve(card, arch, model, params, toks, cache, unembed, windows)
    del cache
    if cfg.mrope:
        serve_vision(card, arch, model, params, toks, unembed)
    if profile is not None:
        serve_tuned(card, arch, model, params, toks, unembed, profile)
    return dict(counts, configs=configs)


def roofline_serve(card: str, arch: str, model, params, toks, cache,
                   unembed, windows: dict) -> None:
    """[roofline] of a served model: its prefill (a frontend family's from
    stand-in embeddings, as the dry run builds it, whose FLOPs the token
    prefill profiled shares) and one decode step against ``cache``, each
    through the serving steps (serve/step.py) the dry run builds."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import frontend
    from repro_torch.serve.step import make_decode_step, make_prefill
    cfg = model.cfg
    b, s = toks.shape
    batch = {"tokens": toks}
    if frontend.needs_embeddings(cfg):
        batch = frontend_batch(cfg, b, s, VISION_GRID,
                               torch.Generator(device="cuda").manual_seed(4),
                               "cuda")
    prefill = make_prefill(model, b, CACHE_LEN)
    roofline_cell(card, arch, cfg, ShapeConfig(f"prefill_{s}", s, b,
                                               "prefill"),
                  lambda p, x, u: prefill(p, x, unembed=u),
                  (params, batch, unembed), windows["prefill"],
                  cache_len=CACHE_LEN)
    del batch
    decode = make_decode_step(model, b, CACHE_LEN)
    roofline_cell(card, arch, cfg, ShapeConfig("decode", CACHE_LEN, b,
                                               "decode"),
                  lambda p, t, c, u: decode(p, t, c, s + 4, unembed=u),
                  (params, toks[:, -1:], cache, unembed),
                  windows["decode x4"], per_call=4)


def serve_vision(card: str, arch: str, model, params, toks, unembed) -> None:
    """The M-RoPE path at full width, through ``Model.prefill`` with
    embeddings: (a) the embeddings of the batch's own tokens (fp32) with
    text-like positions must prefill bit-equal to the tokens (M-RoPE with
    equal streams is RoPE, and the embeddings are cast before the first
    layer); (b) stand-in embeddings with vision-grid positions
    (VISION_GRID), then four decode steps from tokens: finite logits, a
    flash launch per layer in the prefill and none else; its prefill's
    time."""
    import torch
    from repro_torch.models import frontend

    cfg = model.cfg
    b, s = toks.shape
    with torch.no_grad():
        own = {"embeddings": params["embed"][toks.long()].float(),
               "mrope_pos": frontend.fake_mrope_pos(cfg, b, s, "cuda")}
        from_embeddings, _ = model.prefill(params, own, cache_len=CACHE_LEN,
                                           unembed=unembed)
        from_tokens, _ = model.prefill(params, {"tokens": toks},
                                       cache_len=CACHE_LEN, unembed=unembed)
    equal = torch.equal(from_embeddings, from_tokens)
    say("serve", f"{arch} prefill B={b} S={s} from the tokens' embeddings "
        f"(fp32) with text-like M-RoPE positions bit-equal to the prefill "
        f"from the tokens: {equal} {'ok' if equal else 'FAIL'}")
    if not equal:
        fail("serve", "text-like M-RoPE does not reduce to RoPE on the card")
    del own, from_embeddings, from_tokens

    vision = frontend_batch(cfg, b, s, VISION_GRID,
                            torch.Generator(device="cuda").manual_seed(3),
                            "cuda")
    counters = launch_counters()
    with torch.no_grad():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        logits, cache = model.prefill(params, vision, cache_len=CACHE_LEN,
                                      unembed=unembed)
        finite = [torch.isfinite(logits).all()]
        for i in range(4):
            nxt = logits.argmax(-1, keepdim=True)
            logits, cache = model.decode_step(params, nxt, cache, s + i,
                                              unembed=unembed)
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        del cache
        prefill_ms = cuda_ms(lambda: model.prefill(
            params, vision, cache_len=CACHE_LEN, unembed=unembed),
            iters=2, warmup=1)
    want = dict.fromkeys(counters, 0)
    want.update(prefill_launches(cfg))
    ok = counts == want and all(bool(f) for f in finite)
    say("serve", f"{arch} prefill B={b} S={s} from stand-in embeddings with "
        f"vision-grid M-RoPE positions (an image of {VISION_GRID} patches "
        f"after 4 text tokens): {prefill_ms:.2f} ms; then 4 decode steps; "
        f"launches {({k: n for k, n in counts.items() if n})} (expected "
        f"{({k: n for k, n in want.items() if n})}), logits finite "
        f"{all(bool(f) for f in finite)}, on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("serve", f"{arch}: the vision-grid prefill and decode")


MOE_SCOPES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")


def profile_window(name: str, fn, card: str, *, grad: bool = False,
                   share_of: str | tuple = (), top: int = 6,
                   scopes: tuple = ()) -> dict:
    """Device busy share and the ``top`` kernels of one call, from
    torch.profiler: kernel time summed over the window's wall time; with
    ``share_of`` (a name or several), also the share of the kernels whose
    name holds it, and
    each of them; with ``scopes`` (``record_function`` names), the device
    time of the kernels launched inside each (the forward's and remat's
    recomputation; a backward's kernels are launched outside them).
    Returns the window's wall and busy ms and, by ``share_of`` name, the ms
    and launches of its kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.set_grad_enabled(grad), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (host ops also carry their kernels' time),
    # without the scopes' own spans on the device's timeline
    events = prof.key_averages()
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if e.device_type == DeviceType.CUDA and e.key not in scopes]
    busy_us = sum(r[0] for r in rows)
    say("profile", f"{name}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), idle "
        f"{100 * (1 - busy_us / wall_us):.1f}%, {sum(r[1] for r in rows)} "
        f"kernels, on {card} (profiler on)")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        say("profile", f"  {name}: {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}%"
            f" x{count} {key[:90]}")
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3, "shares": {}}
    for key in ([share_of] if isinstance(share_of, str) else share_of):
        if not busy_us:
            break
        mine = [r for r in rows if key in r[2]]
        us = sum(r[0] for r in mine)
        out["shares"][key] = (us / 1e3, sum(r[1] for r in mine))
        say("profile", f"  {name}: kernels named *{key}*: {us / 1e3:.3f} "
            f"ms, {100 * us / busy_us:.1f}% of device busy, "
            f"x{sum(r[1] for r in mine)}")
        for us, count, k in sorted(mine, reverse=True):
            say("profile", f"  {name}: *{key}* {us / 1e3:8.3f} ms x{count} "
                f"{k[:90]}")
    inside = 0.0
    for scope in scopes:
        host = [e for e in events if e.key == scope
                and e.device_type != DeviceType.CUDA]
        us = sum(e.device_time_total for e in host)
        inside += us
        say("profile", f"  {name}: scope {scope}: kernels inside "
            f"{us / 1e3:.3f} ms ({100 * us / max(busy_us, 1e-9):.1f}% of "
            f"device busy), x{sum(e.count for e in host)}")
    if scopes:
        say("profile", f"  {name}: the MoE scopes together {inside / 1e3:.3f}"
            f" ms ({100 * inside / max(busy_us, 1e-9):.1f}% of device busy)")
    return out


def roofline_cell(card: str, arch: str, cfg, shape, fn, args, window: dict,
                  *, per_call: int = 1, cache_len: int | None = None) -> None:
    """[roofline]: ``fn(*args)``, one call of the main path's, counted on
    the card by roofline/step_cost.StepCount, beside the dry run of ``cfg``
    at ``shape`` on the meta device (launch/dryrun.run_one, the same
    step built by its own code), priced at the H100's peaks
    (roofline/analysis.analyze), against ``window``, the call's
    profile_window (``per_call`` calls in it). Fails if the card's and the
    meta count differ in FLOPs (by dtype), if the compute term exceeds the
    measured device-busy time (the count holds work that never ran), or,
    for a training step or a prefill, if the dry run's peak lies outside
    ROOFLINE_PEAK_RANGE of the measured one: torch.cuda's peak over the
    call above what was allocated before it, plus the call's arguments."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.step_cost import StepCount

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with StepCount(args) as count:
        fn(*args)
    torch.cuda.synchronize()
    measured = (torch.cuda.max_memory_allocated() - before
                + count.argument_bytes)
    card_cost = count.cost()
    rec = dryrun.run_one(arch, cfg=cfg, shape=shape, cache_len=cache_len,
                         verbose=False)
    meta = rec["cost_analytic_global"]
    kind = rec["step_kind"]
    rep = analyze(arch=arch, shape=shape, mesh_name=dryrun.MESH, chips=1,
                  step_kind=kind, cost={
                      "flops": card_cost["flops"],
                      "flops_fp32": card_cost["flops_fp32"],
                      "bytes accessed": card_cost["bytes"]},
                  collectives={"total": 0}, cfg=cfg)
    busy_s = window["busy_ms"] / 1e3 / per_call
    wall_s = window["wall_ms"] / 1e3 / per_call
    bound_s = max(rep.compute_s, rep.memory_s)
    peak = rec["memory"]["peak_memory_in_bytes"]
    ratio = peak / measured
    lo, hi = ROOFLINE_PEAK_RANGE
    same = all(card_cost[k] == meta[k]
               for k in ("flops", "flops_bf16", "flops_fp32"))
    kernels = {k.split(".")[-1]: (v["calls"], v["flops"] / 1e12)
               for k, v in card_cost["by_op"].items()
               if k.startswith("repro_torch.")}
    problems = []
    if not same:
        problems.append(f"the card counts {card_cost['flops']:.6e} FLOPs "
                        f"(fp32 {card_cost['flops_fp32']:.6e}), the meta "
                        f"device {meta['flops']:.6e} (fp32 "
                        f"{meta['flops_fp32']:.6e})")
    if not rep.compute_s <= busy_s:
        problems.append(f"compute_s {rep.compute_s:.6f} s exceeds the "
                        f"measured device busy {busy_s:.6f} s")
    if kind != "decode" and not lo <= ratio <= hi:
        problems.append(f"the dry run's peak {peak / 1e9:.3f} GB is "
                        f"{ratio:.3f}x the measured {measured / 1e9:.3f} GB")
    say("roofline", f"{arch} {kind} B={shape.global_batch} S={shape.seq_len}"
        f": FLOPs {card_cost['flops'] / 1e12:.4f} T (bf16 "
        f"{card_cost['flops_bf16'] / 1e12:.4f}, fp32 "
        f"{card_cost['flops_fp32'] / 1e12:.4f}; kernels {kernels}), bytes "
        f"{card_cost['bytes'] / 1e9:.3f} GB; card count == meta count: "
        f"{same}; compute_s {1e3 * rep.compute_s:.3f} ms, memory_s "
        f"{1e3 * rep.memory_s:.3f} ms -> {rep.bottleneck} (H100 peaks: 989 "
        f"TFLOP/s bf16, 67 fp32, 3.35 TB/s); measured wall "
        f"{1e3 * wall_s:.3f} ms, device busy {1e3 * busy_s:.3f} ms; roofline "
        f"max(compute_s, memory_s) {100 * bound_s / busy_s:.1f}% of busy, "
        f"{100 * bound_s / wall_s:.1f}% of wall; peak: dry run "
        f"{peak / 1e9:.3f} GB, measured {measured / 1e9:.3f} GB (ratio "
        f"{ratio:.3f}{'' if kind == 'decode' else f', gate {lo}-{hi}'}), the"
        f" count's own tracker on the card {count.peak / 1e9:.3f} GB; dry "
        f"run traced in {rec['trace_s']:.2f} s; "
        f"{'FAIL' if problems else 'ok'}, on {card}")
    if problems:
        fail("roofline", f"{arch} {kind}: " + "; ".join(problems))


def phase_small_reference(card: str, arch: str) -> None:
    """The card against the plain CPU path (which the CPU tests hold
    against the JAX package) on tiny ``arch`` (``tiny_config``) in bf16,
    same weights: prefill of 100 tokens into a ring of 128 (which the
    hybrid's and mixtral's window of 64 bounds and wraps) and three decode
    steps, to REFERENCE_ROW_RTOL; a frontend family's prefill is from
    stand-in embeddings (with M-RoPE, vision-grid positions of an image of
    TINY_VISION_GRID patches), then four decode steps from tokens. An MoE
    config's routing decisions are compared first (``flipped_tokens``),
    and a sequence's row of logits is left out from the step its token
    took other experts on."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models import frontend
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_map

    cfg = tiny_config(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    b, s = 4, 100
    if frontend.needs_embeddings(cfg):
        first = frontend_batch(cfg, b, s, TINY_VISION_GRID,
                               torch.Generator().manual_seed(1), "cpu")
        steps, inputs = 4, ", ".join(first)
    else:
        first = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32))}
        steps, inputs = 3, "tokens"
    bad = torch.zeros((b, s + steps), dtype=torch.bool)
    worst, left_out, margins, calls = 0.0, 0, [], 0

    def step(run_cpu, run_gpu, pos, rows):
        nonlocal worst, left_out, calls
        with Routes() as rc:
            lc, cc = run_cpu()
        with Routes() as rg:
            lg, cg = run_gpu()
        calls += len(rc.calls)
        if cfg.moe:
            flips, m = flipped_tokens(rc.calls, rg.calls,
                                      cfg.moe.experts_per_token)
            margins.extend(m)
            bad[rows] |= flips.reshape(b, -1)
        keep = ~bad[:, pos]
        left_out += int((~keep).sum())
        worst = max(worst, row_rel_err(lg.cpu()[keep], lc[keep]))
        return lc, cc, cg

    with torch.no_grad():
        lc, cc, cg = step(
            lambda: cpu.prefill(p_cpu, first, cache_len=128),
            lambda: gpu.prefill(p_gpu, {k: t.cuda() for k, t in first.items()},
                                cache_len=128), s - 1, np.s_[:, :s])
        for i in range(steps):
            nxt = lc.argmax(-1, keepdim=True)
            lc, cc, cg = step(
                lambda: cpu.decode_step(p_cpu, nxt, cc, s + i),
                lambda: gpu.decode_step(p_gpu, nxt.cuda(), cg, s + i),
                s + i, np.s_[:, s + i:s + i + 1])
    ok = math.isfinite(worst) and worst <= REFERENCE_ROW_RTOL
    routing = ""
    if cfg.moe:
        routing = (f"; routing: {calls} router calls, {int(bad.sum())} of "
                   f"{b * (s + 3)} tokens took other experts on the card "
                   f"(first flips' margins {[f'{m:.2e}' for m in margins]}, "
                   f"all within {FLIP_MARGIN}), {left_out} of "
                   f"{(1 + steps) * b} logit rows left out")
    say("reference", f"{cfg.name} ({cfg.num_layers} layers) bf16, card vs "
        f"CPU plain path: prefill from {inputs} + {steps} "
        f"decode steps, worst row rel L2 logit err {worst:.3e} (tol "
        f"{REFERENCE_ROW_RTOL}){routing} {'ok' if ok else 'FAIL'} on {card}")
    if not ok or left_out > 2 * b:
        fail("reference", "the card disagrees with the CPU path")


def phase_small_train_reference(card: str, arch: str) -> None:
    """One train step of tiny ``arch`` (``tiny_config``), bf16 over fp32
    masters, on the card against the plain CPU path (which the CPU tests
    hold against the JAX package's train step): the loss, the gradient
    norm and each gradient leaf (the hybrid's shared block's among them).
    The parameters after the step are not compared: Adam's first step is
    ~lr * sign(g), which bf16 noise in a near-zero gradient flips.
    Every leaf is held to TRAIN_GRAD_ROW_RTOL by its relative L2 error,
    and by its worst row. The worst row's gate was set on the two-layer
    tiny configs; bf16's own error grows with depth (the CPU's bf16 path
    against its fp32 path, no kernel involved, errs up to 0.16 in a row
    of tiny zamba2-1.2b's dt_proj at five layers, 0.12 at a five-layer
    mamba2-370m, 0.07 at two layers), and an MoE router's gradient, which
    subtracts near-equal terms (p (dp - sum p dp)), errs by 0.095 in a row
    of tiny moonshot-v1-16b-a3b's and 0.165 of tiny mixtral-8x22b's at two
    layers, routed alike. So a deeper config (TINY_OVERRIDES) or an MoE
    config holds each leaf's worst row to the larger of the gate and twice
    that leaf's bf16-vs-fp32 worst row on the CPU: two bf16 paths that
    round independently differ by ~sqrt(2) times one's error, and the
    worst of many rows spreads more. An MoE config's routing
    decisions on the card are held to the CPU's (``flipped_tokens``), and
    its gradients compared with the card routed as the CPU was: a token
    that took other experts moves the leaves that sum few tokens by O(1)
    over their count. A frontend family trains from stand-in embeddings
    (with M-RoPE, vision-grid positions): its ``embed`` leaf's gradient
    must be exactly zero on both devices, and is left out of the gates."""
    import torch
    from repro_torch.data.loader import Loader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models import frontend
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init, tree_leaves,
                                         tree_map)
    from repro_torch.train.step import loss_and_grads, make_train_step

    cfg = tiny_config(arch)
    models = {"cpu": Model(cfg, device="cpu"), "cuda": Model(cfg, device="cuda")}
    p_cpu = models["cpu"].init(torch.Generator().manual_seed(0),
                               dtype=torch.float32)
    stream = SyntheticStream(cfg.vocab_size, 0)
    stand_in = frontend.needs_embeddings(cfg)

    def make_batch(dev):
        batch = Loader(stream, 4, 128, dev)(0)
        if stand_in:
            batch = dict(frontend_batch(cfg, 4, 128, TINY_VISION_GRID,
                                        torch.Generator().manual_seed(2),
                                        dev), labels=batch["labels"])
        return batch

    def run(dev, force=None):
        model = models[dev]
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        batch = make_batch(dev)
        grads = tree_map(torch.zeros_like, params)
        with Routes(force) as routes:
            loss_and_grads(model, params, batch, grads)
            _, _, metrics = make_train_step(model, AdamWConfig())(
                params, adamw_init(params), batch)
        return grads, {k: float(v) for k, v in metrics.items()}, routes.calls

    g_cpu, m_cpu, cpu_calls = run("cpu")
    g_gpu, m_gpu, gpu_calls = run("cuda")
    routing = ""
    if cfg.moe:
        n = cfg.num_layers
        flips, margins = flipped_tokens(cpu_calls[:n], gpu_calls[:n],
                                        cfg.moe.experts_per_token)
        free = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
                for k in ("loss", "aux")}
        g_gpu, m_gpu, _ = run("cuda", force=[idx for _, idx in cpu_calls[:n]])
        routing = (f"; routing: {int(flips.sum())} of {flips.numel()} tokens"
                   f" took other experts on the card (margins "
                   f"{[f'{m:.2e}' for m in margins]}), as routed loss rel "
                   f"{free['loss']:.2e} and aux rel {free['aux']:.2e}; the "
                   "gradients with the card routed as the CPU's")
        if not free["loss"] <= TRAIN_LOSS_RTOL:
            fail("reference", f"the card's loss as routed: {routing}")
    tols = [TRAIN_GRAD_ROW_RTOL] * len(tree_leaves(g_cpu))
    if arch in TINY_OVERRIDES or cfg.moe:
        fp32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        g_fp32 = tree_map(torch.zeros_like, p_cpu)
        n = cfg.num_layers
        with Routes([idx for _, idx in cpu_calls[:n]] if cfg.moe else None):
            loss_and_grads(fp32, p_cpu, make_batch("cpu"), g_fp32)
        tols = [max(t, 2 * row_rel_err(a, b, floor=GRAD_ROW_FLOOR))
                for t, a, b in zip(tols, tree_leaves(g_cpu),
                                   tree_leaves(g_fp32))]
    worst, where, tol, leaf_worst = 0.0, "", TRAIN_GRAD_ROW_RTOL, 0.0
    names = [f"{k}/{n}" if isinstance(v, dict) else k
             for k, v in sorted(g_cpu.items())
             for n in (sorted(v) if isinstance(v, dict) else [None])]
    zero_embed = None
    for name, ref, got, t in zip(names, tree_leaves(g_cpu),
                                 tree_leaves(g_gpu), tols):
        got = got.cpu()
        if stand_in and name == "embed":
            zero_embed = not ref.any() and not got.any()
            continue
        err = row_rel_err(got, ref, floor=GRAD_ROW_FLOOR)
        leaf_worst = max(leaf_worst, ((got - ref).norm() / ref.norm()).item())
        if not err / t <= worst / tol:
            worst, where, tol = err, name, t
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    ok = (math.isfinite(worst) and worst <= tol
          and leaf_worst <= TRAIN_GRAD_ROW_RTOL
          and all(r <= TRAIN_LOSS_RTOL for r in rel.values())
          and zero_embed is not False)
    if stand_in:
        routing += (f"; from stand-in embeddings ({', '.join(make_batch('cpu'))}"
                    f"), the embed leaf's gradient exactly zero on both: "
                    f"{zero_embed}")
    say("reference", f"{cfg.name} train step, bf16 over fp32 masters, card "
        f"vs CPU plain path: loss {m_gpu['loss']:.5f} vs {m_cpu['loss']:.5f}"
        f" (rel {rel['loss']:.2e}), grad_norm {m_gpu['grad_norm']:.5f} vs "
        f"{m_cpu['grad_norm']:.5f} (rel {rel['grad_norm']:.2e}; tol "
        f"{TRAIN_LOSS_RTOL}); worst leaf rel L2 err {leaf_worst:.3e} (tol "
        f"{TRAIN_GRAD_ROW_RTOL}); worst gradient row rel L2 err against its "
        f"tol {worst:.3e} in {where} (tol {tol:.3e}; leaves whose row tol is"
        f" twice the CPU's own bf16 error, above {TRAIN_GRAD_ROW_RTOL}: "
        f"{sum(t > TRAIN_GRAD_ROW_RTOL for t in tols)} of {len(tols)})"
        f"{routing} {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail("reference", "the card's train step disagrees with the CPU path")


def phase_train(card: str, arch: str, profile=None) -> dict:
    """``arch`` at full width (at TRAIN_LAYERS[arch] layers where its
    state does not fit the card) takes TRAIN_STEPS AdamW steps at
    TRAIN_BATCHES[arch] x TRAIN_SEQ; returns every kernel's launches over
    the run. A frontend family trains on stand-in embeddings drawn anew
    each step (with M-RoPE, vision-grid positions of an image of
    VISION_GRID patches) and the stream's labels. With a tuning ``profile``,
    four more steps in turns, default, tuned, tuned, default configs
    (``train_tuned``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.loader import Loader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.models import frontend
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    free_card()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    cut = ""
    if arch in TRAIN_LAYERS:
        cut = f" (of {cfg.num_layers}: depth cut to fit the card)"
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    batch_size = TRAIN_BATCHES[arch]
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    params, opt = state.params, state.opt
    torch.cuda.synchronize()
    n_params = model.count_params()
    say("train", f"{arch}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, fp32 masters + AdamW mu/nu "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, compute {cfg.dtype}, "
        f"remat {model.remat}; init {time.perf_counter() - t0:.1f} s")
    tokens_loader = Loader(SyntheticStream(cfg.vocab_size, 0), batch_size,
                           TRAIN_SEQ, "cuda")

    def loader(step):
        batch = tokens_loader(step)
        if not frontend.needs_embeddings(cfg):
            return batch
        gen = torch.Generator(device="cuda").manual_seed(100 + step)
        return dict(frontend_batch(cfg, batch_size, TRAIN_SEQ, VISION_GRID,
                                   gen, "cuda"), labels=batch["labels"])

    lr = TRAIN_LRS.get(arch, TRAIN_LR)
    step_fn = make_train_step(model, AdamWConfig(lr=lr))
    counters = launch_counters()
    # each forward kernel twice (forward, remat's recompute), its backward
    # once
    fwd = prefill_launches(cfg)
    want = dict.fromkeys(counters, 0)
    want.update({name: 2 * n for name, n in fwd.items()},
                flash_attention_bwd=fwd["flash_attention"],
                ssd_bwd=fwd["ssd"])
    want.update(loss_launches(cfg, batch_size, TRAIN_SEQ))
    share_of = tuple(k for k, name in (("flash_bwd", "flash_attention"),
                                       ("ssd", "ssd")) if fwd[name])
    losses, gnorms, times, total = [], [], [], dict.fromkeys(counters, 0)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        batch = loader(step)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {name: fn.launches for name, fn in counters.items()}
        if counts != want:
            fail("train", f"{arch} step {step}: kernel launches {counts}, "
                 f"expected {want} (per attention call and Mamba2 layer: "
                 "forward + remat recompute, backward; the loss's fold and "
                 "gradient pass once per vocabulary chunk)")
        for name, n in counts.items():
            total[name] += n
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        say("train", f"{arch} step {step}: loss {losses[-1]:.4f}, grad_norm "
            f"{gnorms[-1]:.3f}, {1e3 * times[-1]:.1f} ms, launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("train", f"non-finite loss or gradient norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail("train", f"loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not peak < CARD_BYTES:
        fail("train", f"peak memory {peak / 1e9:.2f} GB exceeds the card's 80 GB")
    step_s = statistics.median(times[2:])
    tokens = batch_size * TRAIN_SEQ
    # N: every parameter outside the embedding, once per use: the hybrid's
    # shared block once per call; of an MoE layer's experts the k a token
    # is routed to (the capacity's padding rows not counted)
    n_matmul = n_params - cfg.vocab_size * cfg.d_model
    calls, per_call = fwd["flash_attention"], ""
    if cfg.moe:
        n_matmul = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
        per_call = (f", active: {cfg.moe.experts_per_token} of "
                    f"{cfg.moe.num_experts} experts, capacity padding not "
                    "counted")
    if cfg.arch_type == "hybrid":
        n_matmul += (calls - 1) * sum(t.numel()
                                      for t in params["shared_attn"].values())
        per_call = f", the shared block once per call ({calls})"
    if frontend.needs_embeddings(cfg):
        per_call = (f", from stand-in embeddings "
                    f"({', '.join(loader(0))}): embed unused")
    attn = 3.5 * calls * attention_flops(batch_size, cfg.num_heads,
                                         TRAIN_SEQ, cfg.head_dim)
    model_flops = 6 * n_matmul * tokens + attn
    extra = [f"attention, in the MFU, {attn / 1e12:.2f} T"] if calls else []
    if fwd["ssd"]:
        s_cfg = cfg.ssm
        heads = s_cfg.expand * cfg.d_model // s_cfg.head_dim
        shape = (batch_size, TRAIN_SEQ, heads, s_cfg.head_dim, s_cfg.ngroups,
                 s_cfg.state_dim)
        ssd = fwd["ssd"] * (ssd_flops(*shape) + ssd_bwd_flops(*shape))
        extra.append(f"the SSD's own, forward + backward, in no MFU, "
                     f"{ssd / 1e12:.2f} T")
    say("train", f"{arch}: {TRAIN_STEPS} steps B={batch_size} S={TRAIN_SEQ} "
        f"lr {lr:g}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; median step (steps 3-"
        f"{TRAIN_STEPS}) {1e3 * step_s:.1f} ms (all: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}), {tokens / step_s:.0f}"
        f" tokens/s, model FLOPs {model_flops / 1e12:.2f} T per step (6 N T, "
        f"N = {n_matmul / 1e9:.3f} B outside the embedding{per_call}; "
        f"{'; '.join(extra)}; remat's recompute not counted) = "
        f"{100 * model_flops / step_s / PEAK_BF16_FLOPS:.1f}% MFU of 989 "
        f"TFLOP/s; peak memory {peak / 1e9:.2f} GB ({(CARD_BYTES - peak) / 1e9:.2f}"
        f" GB of 80 free); launches over the run {total}, on {card}")
    data = loader(TRAIN_STEPS)
    prof = profile_window(f"{arch} train step", lambda: step_fn(params, opt,
                                                                data),
                          card, grad=True, share_of=share_of, top=14,
                          scopes=MOE_SCOPES if cfg.moe else ())
    roofline_cell(card, arch, cfg, ShapeConfig(
        f"train_{TRAIN_SEQ}", TRAIN_SEQ, batch_size, "train"), step_fn,
        (params, opt, loader(TRAIN_STEPS + 9)), prof)
    if "flash_bwd" in prof["shares"]:
        bwd_ms, n = prof["shares"]["flash_bwd"]
        say("train", f"{arch}: the flash backward ({n} kernels: "
            f"{want['flash_attention_bwd']} launches at Hq={cfg.num_heads}, "
            f"Hkv={cfg.num_kv_heads}, D={cfg.head_dim}) takes {bwd_ms:.3f} ms"
            f" of the profiled step's {prof['wall_ms']:.2f} ms wall "
            f"({100 * bwd_ms / prof['wall_ms']:.1f}% of the step, "
            f"{100 * bwd_ms / prof['busy_ms']:.1f}% of device busy), on "
            f"{card}")
    if profile is not None:
        params, opt = train_tuned(card, arch, cfg, step_fn, params, opt,
                                  loader, want, profile)
    del params, opt, state, step_fn, data
    free_card()
    return total


def train_tuned(card: str, arch: str, cfg, step_fn, params, opt, loader,
                want: dict, profile):
    """Training steps in turns on the default configs and under the tuned
    profile (default, tuned, tuned, default), each with its launches
    exact and, under the profile, every forward launch at the profile's
    config for the step's shape; the step's time both ways. Returns the
    params and optimizer state."""
    import torch
    from repro_torch.tune.profile import use_profile
    picked = {way: tuned_configs(cfg, prof, TRAIN_SEQ)
              for way, prof in (("tuned", profile), ("default", None))}
    times = {"default": [], "tuned": []}
    for i, way in enumerate(("default", "tuned", "tuned", "default")):
        batch = loader(TRAIN_STEPS + 1 + i)
        with use_profile(profile if way == "tuned" else None):
            torch.cuda.synchronize()
            counters = reset_launches()
            t0 = time.perf_counter()
            params, opt, _ = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t0)
        counts = {name: fn.launches for name, fn in counters.items()}
        by_config = config_launches()
        expect = {k: {picked[way][k]: want[k]} if want[k] else {}
                  for k in ("flash_attention", "ssd")}
        if counts != want or by_config != expect:
            fail("train", f"{arch} {way} step: launches {counts} by config "
                 f"{by_config}, expected {want} by config {expect}")
    say("train", f"{arch} steps under the tuned profile (its {picked['tuned']} at "
        f"B={TRAIN_BATCHES[arch]} S={TRAIN_SEQ}; launches per step exact, "
        f"{want['flash_attention']} forward flash launches at that config): "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times['tuned'])} ms tuned, "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times['default'])} ms on the "
        f"default configs (in turns: default, tuned, tuned, default), on "
        f"{card}")
    return params, opt


# the [shard] phase: a sequence shard's q rows at their offset, and the
# sharded model on a one-device NCCL mesh
SHARD_KERNEL_SHAPES = {  # name: (B, S, Hq, Hkv, D, window); 4 shards of S
    QWEN: (2, 2048, 16, 2, 128, 0), ZAMBA: (8, 2048, 32, 32, 64, 4096)}
SHARD_PIECES = 4
SHARD_TRAIN_STEPS = 8
# [shard]: moonshot-v1-16b-a3b's prefill at the training cells' depth cut
SHARD_MOON_LAYERS = TRAIN_LAYERS[MOON]


def phase_shard_kernels(card: str) -> None:
    """The flash kernels on sequence shards at full width: q cut into
    SHARD_PIECES pieces at offsets 0, S/4, S/2, 3S/4 (whole q tiles)
    against the whole K/V, as the sharded model's attention island calls
    them; each piece's o, LSE and dQ and the summed dK/dV held to the
    plain versions by the row gates; the pieces' forward rows against the
    unsharded call's bits; the deterministic backward two calls bit-equal
    on each piece."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_deterministic)
    from repro_torch.kernels.ref import (attention_backward_reference,
                                         attention_lse_reference, row_rel_err)
    gen = torch.Generator(device="cuda").manual_seed(7)
    failed = []
    for arch, (b, s, hq, hkv, d, window) in SHARD_KERNEL_SHAPES.items():
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        n = s // SHARD_PIECES
        whole = flash_attention(q, k, v, causal=True, window=window)
        kt, vt = (t.transpose(1, 2) for t in (k, v))
        # the plain gradients of the whole sequence: dK, dV sum its pieces'
        _, dk_ref, dv_ref = (g.transpose(1, 2) for g in
                             attention_backward_reference(
                                 q.transpose(1, 2), kt, vt, do.transpose(1, 2),
                                 window=window))
        rows, dk_sum, dv_sum, errs, det_equal = [], 0, 0, {}, True
        for i in range(SHARD_PIECES):
            off = i * n
            qi, doi = (t[:, off:off + n].contiguous() for t in (q, do))
            o, lse = flash_attention(qi, k, v, causal=True, window=window,
                                     q_offset=off, return_lse=True)
            dq, dk, dv = flash_attention_bwd(qi, k, v, lse, doi, causal=True,
                                             window=window, q_offset=off)
            det = [flash_attention_bwd_deterministic(
                qi, k, v, lse, doi, causal=True, window=window, q_offset=off)
                for _ in range(2)]
            det_equal &= all(torch.equal(x, y) for x, y in zip(*det))
            o_ref, lse_ref = attention_lse_reference(
                qi.transpose(1, 2), kt, vt, window=window, q_offset=off)
            (dq_ref,) = (attention_backward_reference(
                qi.transpose(1, 2), kt, vt, doi.transpose(1, 2),
                window=window, q_offset=off)[0].transpose(1, 2),)
            for name, x, r, floor in (
                    ("o", o, o_ref.transpose(1, 2), 0.0), ("lse", lse,
                                                           lse_ref, 0.0),
                    ("dq", dq, dq_ref, GRAD_ROW_FLOOR)):
                errs[name] = max(errs.get(name, 0.0),
                                 row_rel_err(x, r, floor=floor))
            errs["lse_abs"] = max(errs.get("lse_abs", 0.0),
                                  (lse - lse_ref).abs().max().item())
            rows.append(o)
            dk_sum = dk_sum + dk.float()
            dv_sum = dv_sum + dv.float()
        errs["dk"] = row_rel_err(dk_sum, dk_ref, floor=GRAD_ROW_FLOOR)
        errs["dv"] = row_rel_err(dv_sum, dv_ref, floor=GRAD_ROW_FLOOR)
        bits = torch.equal(torch.cat(rows, 1), whole)
        ok = (all(math.isfinite(e) for e in errs.values())
              and max(errs[x] for x in ("o", "lse", "dq", "dk", "dv"))
              <= KERNEL_ROW_RTOL and errs["lse_abs"] <= LSE_ABS_TOL
              and det_equal)
        if not ok:
            failed.append(arch)
        say("shard", f"flash on {SHARD_PIECES} sequence shards of {arch}'s "
            f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={window} (q_offset "
            f"0, {n}, {2 * n}, {3 * n}): worst row rel L2 o {errs['o']:.3e}, "
            f"LSE {errs['lse']:.3e} (abs {errs['lse_abs']:.3e}), dQ "
            f"{errs['dq']:.3e}, summed dK {errs['dk']:.3e}, dV "
            f"{errs['dv']:.3e} (tol {KERNEL_ROW_RTOL}; LSE abs "
            f"{LSE_ABS_TOL}); the pieces' forward rows bit-equal to the "
            f"unsharded call's: {bits}; deterministic backward two calls "
            f"bit-equal: {det_equal} {'ok' if ok else 'FAIL'}")
        del q, k, v, do, whole, rows, dk_sum, dv_sum
        free_card()
    if failed:
        fail("shard", f"the offset kernels disagree with plain: {failed}")


def phase_shard_model(card: str) -> None:
    """The sharded path (``Model(cfg, make_rules(mesh))``: DTensors, the
    islands) on a one-device NCCL ``DeviceMesh`` (1, 1) at full width,
    against the plain path on the same weights: qwen2.5-3b served (8
    requests through ServeEngine) and trained (SHARD_TRAIN_STEPS steps,
    B = 2 x S = 2048), mamba2-370m prefilled and decoded, moonshot
    prefilled at SHARD_MOON_LAYERS layers (the tp MoE island). Every
    kernel launch count equals the plain path's; prefill logits and decodes
    are held by the row gates, greedy tokens equal, the losses within the
    [train] gate; the host cost of DTensor's dispatch is the times beside
    the plain path's. The group is destroyed at the end, before [resume]
    and [boot], whose launcher children must not inherit it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store_dir = tempfile.mkdtemp(prefix="shard-store-", dir=ROOT / "build")
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(store_dir) / "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        failed = []
        for arch, fn in ((QWEN, _shard_serve), (MAMBA, _shard_serve),
                         (MOON, _shard_serve), (QWEN, _shard_train)):
            if not fn(card, arch, mesh):
                failed.append(f"{arch} {fn.__name__}")
            free_card()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    if failed:
        fail("shard", f"the sharded path disagrees with the plain: {failed}")


def _shard_model(arch: str, mesh):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import make_rules
    cfg = get_config(arch)
    if arch == MOON:
        cfg = dataclasses.replace(cfg, num_layers=SHARD_MOON_LAYERS)
    return cfg, Model(cfg, device="cuda"), Model(cfg, make_rules(mesh))


def _shard_serve(card: str, arch: str, mesh) -> bool:
    """Prefill and decodes (and for qwen2.5-3b ServeEngine's 8 requests)
    on the plain and the sharded path; True if they agree."""
    import torch
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models.sharded import shard_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, plain, sharded = _shard_model(arch, mesh)
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    dparams = shard_params(params, sharded.rules, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LENS[1]),
                         generator=gen, device="cuda", dtype=torch.int32)
    out, times, counts, fed = {}, {}, {}, None
    for name, model, p in (("plain", plain, params),
                           ("sharded", sharded, dparams)):
        unembed = model.unembed_table(p)
        with torch.no_grad():   # warm-up: the first call of each path
            model.prefill(p, {"tokens": toks}, cache_len=CACHE_LEN,
                          unembed=unembed)
        counters = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(p, {"tokens": toks},
                                          cache_len=CACHE_LEN,
                                          unembed=unembed)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        counts[name] = {k: c.launches for k, c in counters.items()}
        full = logits.full_tensor() if name == "sharded" else logits
        # both paths decode the plain path's greedy tokens, so that a
        # near-tie cannot send them down different sequences
        decodes, nxt = [], full.argmax(-1).int()
        tokens = fed if fed is not None else []
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(4):
                if fed is None:
                    tokens.append(nxt)
                lg, cache = model.decode_step(p, tokens[i][:, None], cache,
                                              PROMPT_LENS[1] + i,
                                              unembed=unembed)
                lg = lg.full_tensor() if name == "sharded" else lg
                decodes.append(lg)
                nxt = lg.argmax(-1).int()
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / 4
        fed = tokens
        out[name] = (full, torch.stack(decodes))
        times[name] = (prefill_ms, decode_ms)
        del cache
    (pl, pd), (sl, sd) = out["plain"], out["sharded"]
    prefill_err = row_rel_err(sl, pl)
    decode_err = row_rel_err(sd, pd)
    same_tokens = torch.equal(pl.argmax(-1), sl.argmax(-1)) and torch.equal(
        pd.argmax(-1), sd.argmax(-1))
    want = dict.fromkeys(counts["plain"], 0)
    want.update(prefill_launches(cfg))
    ok = (prefill_err <= REFERENCE_ROW_RTOL and decode_err <= CONSISTENCY_RTOL
          and same_tokens and counts["plain"] == counts["sharded"] == want)
    engine_note = ""
    if arch == QWEN:
        got = {}
        for name, model, p in (("plain", plain, params),
                               ("sharded", sharded, dparams)):
            engine = ServeEngine(model, p, batch=BATCH, cache_len=CACHE_LEN,
                                 device=model.device)
            reqs = [Request(prompt=toks[i, :PROMPT_LENS[i % 2]].cpu().numpy(),
                            max_new_tokens=NEW_TOKENS) for i in range(BATCH)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = [r.generated for r in engine.generate(reqs)]
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0,)
        ok &= got["plain"] == got["sharded"]
        engine_note = (f"; ServeEngine, {BATCH} requests of "
                       f"{NEW_TOKENS} tokens: greedy tokens equal "
                       f"{got['plain'] == got['sharded']}, "
                       f"{times['sharded'][2]:.2f} s sharded, "
                       f"{times['plain'][2]:.2f} s plain")
    say("shard", f"{arch} on a (1, 1) NCCL mesh, {cfg.num_layers} layers: "
        f"prefill logits bit-equal {torch.equal(sl, pl)} (worst row rel L2 "
        f"{prefill_err:.3e}, tol {REFERENCE_ROW_RTOL}), 4 decodes bit-equal "
        f"{torch.equal(sd, pd)} ({decode_err:.3e}, tol {CONSISTENCY_RTOL}), "
        f"greedy tokens equal {same_tokens}; launches {counts['sharded']} "
        f"(plain {counts['plain']}); prefill {times['sharded'][0]:.1f} ms "
        f"(plain {times['plain'][0]:.1f}), decode "
        f"{times['sharded'][1]:.1f} ms a step (plain "
        f"{times['plain'][1]:.1f}){engine_note}; {card} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def _shard_train(card: str, arch: str, mesh) -> bool:
    """The first step's gradient and SHARD_TRAIN_STEPS AdamW steps from the
    same masters on the plain and the sharded path: every gradient leaf
    within TRAIN_GRAD_ROW_RTOL of the plain path's by its worst row (the
    fast flash backward's atomics make neither path's bits repeat: the
    plain path's own second call is printed beside it), the
    losses within TRAIN_LOSS_RTOL, launches equal. The peak is the steps'."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.checkpoint import flat_with_names
    from repro_torch.data.loader import Loader, ShardedLoader
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ref import row_rel_err
    from repro_torch.models.sharded import shard_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
    from repro_torch.train.step import loss_and_grads, make_train_step
    cfg, plain, sharded = _shard_model(arch, mesh)
    runs, plain_grads, grad_errs, noise = {}, None, {}, {}

    def first_grads(model, params, loader):
        grads = tree_map(torch.zeros_like, params)
        loss_and_grads(model, params, loader(0), grads)
        return grads

    def leaf_errs(grads) -> dict:
        out = {}
        for key, g in flat_with_names(grads):
            if isinstance(g, DTensor):
                g = g.full_tensor()
            ref = plain_grads[key].cuda()
            out[key] = (row_rel_err(g, ref, floor=GRAD_ROW_FLOOR),
                        torch.equal(g, ref))
        return out

    for name, model in (("plain", plain), ("sharded", sharded)):
        free_card()
        params = plain.init(torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.float32)
        stream = SyntheticStream(cfg.vocab_size, 0)
        if name == "sharded":
            params = shard_params(params, model.rules, cfg)
            loader = ShardedLoader(stream, model.rules, TRAIN_BATCH,
                                   TRAIN_SEQ)
        else:
            loader = Loader(stream, TRAIN_BATCH, TRAIN_SEQ, "cuda")
        grads = first_grads(model, params, loader)
        if name == "plain":   # kept on the host, one leaf back at a time
            plain_grads = dict(flat_with_names(tree_map(
                lambda t: t.cpu(), grads)))
            # the plain path against itself: the yardstick of the gate
            del grads
            grads = first_grads(model, params, loader)
            noise = leaf_errs(grads)
        else:
            grad_errs = leaf_errs(grads)
            plain_grads = None
        del grads
        free_card()
        torch.cuda.reset_peak_memory_stats()
        opt = adamw_init(params)
        step_fn = make_train_step(model, AdamWConfig(lr=TRAIN_LR))
        counters = reset_launches()
        losses, times = [], []
        for step in range(SHARD_TRAIN_STEPS):
            batch = loader(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
        runs[name] = dict(losses=losses,
                          step_ms=1e3 * statistics.median(times[1:]),
                          peak=torch.cuda.max_memory_allocated() / 1e9,
                          launches={k: c.launches
                                    for k, c in counters.items()})
        del params, opt, batch, metrics
    p, s = runs["plain"], runs["sharded"]
    worst = max(abs(a - b) / abs(a) for a, b in zip(p["losses"], s["losses"]))
    worst_leaf = max(grad_errs, key=lambda k: grad_errs[k][0])
    noise_leaf = max(noise, key=lambda k: noise[k][0])
    grad_equal = sum(eq for _, eq in grad_errs.values())
    # each forward kernel twice a step (forward, remat's recompute), its
    # backward once
    fwd = prefill_launches(cfg)
    want = dict.fromkeys(s["launches"], 0)
    want.update({k: 2 * n * SHARD_TRAIN_STEPS for k, n in fwd.items()},
                flash_attention_bwd=fwd["flash_attention"] * SHARD_TRAIN_STEPS,
                ssd_bwd=fwd["ssd"] * SHARD_TRAIN_STEPS)
    # the plain path's loss is the vocab-chunked operator, the mesh's its
    # own composition (no kernel)
    want_plain = dict(want, **{k: n * SHARD_TRAIN_STEPS for k, n in
                               loss_launches(cfg, TRAIN_BATCH,
                                             TRAIN_SEQ).items()})
    ok = (worst <= TRAIN_LOSS_RTOL and s["launches"] == want
          and p["launches"] == want_plain
          and all(math.isfinite(x) for x in s["losses"])
          and all(math.isfinite(e) and e <= TRAIN_GRAD_ROW_RTOL
                  for e, _ in grad_errs.values())
          and s["peak"] < CARD_BYTES / 1e9)
    say("shard", f"{arch} trained {SHARD_TRAIN_STEPS} steps at B = "
        f"{TRAIN_BATCH} x S = {TRAIN_SEQ} on a (1, 1) NCCL mesh: the first "
        f"step's {len(grad_errs)} gradient leaves against the plain path's, "
        f"worst row rel L2 {grad_errs[worst_leaf][0]:.3e} ({worst_leaf}, tol "
        f"{TRAIN_GRAD_ROW_RTOL}, floor {GRAD_ROW_FLOOR} x median), "
        f"{grad_equal} bit-equal; the plain path's against its own second "
        f"call {noise[noise_leaf][0]:.3e} ({noise_leaf}), "
        f"{sum(eq for _, eq in noise.values())} bit-equal; loss "
        f"{s['losses'][0]:.4f} -> {s['losses'][-1]:.4f} (plain "
        f"{p['losses'][0]:.4f} -> {p['losses'][-1]:.4f}), worst relative "
        f"difference {worst:.3e} (tol {TRAIN_LOSS_RTOL}), losses bit-equal "
        f"{p['losses'] == s['losses']}; launches {s['launches']} (plain "
        f"{p['launches']}); step {s['step_ms']:.1f} ms (plain "
        f"{p['step_ms']:.1f}, median of steps 2-{SHARD_TRAIN_STEPS}), peak "
        f"{s['peak']:.2f} GB (plain {p['peak']:.2f}); {card} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_moe_block(card: str) -> None:
    """moonshot-v1-16b-a3b's MoE block at its training shape (B = 2 x S =
    2048 tokens, D = 2048, 64 experts, top 6, F = 1408; bf16 activations,
    fp32 weights as the training masters): a forward and backward twice
    under deterministic algorithms, every output and gradient bit-equal;
    the same without them; the block's time and its scopes' split."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOON)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    b, s = TRAIN_BATCHES[MOON], TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    x, dy = (randn(b, s, d).bfloat16() for _ in range(2))
    weights = (randn(d, e, std=0.02), randn(e, d, f, std=0.02),
               randn(e, d, f, std=0.02), randn(e, f, d, std=0.002))

    def run():
        leaves = [t.detach().requires_grad_() for t in (x,) + weights]
        y, aux = moe.moe_block(*leaves, moe=cfg.moe)
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])
        return [y.detach(), aux.detach()] + [t.grad for t in leaves]

    torch.use_deterministic_algorithms(True)
    try:
        det = [run(), run()]
    finally:
        torch.use_deterministic_algorithms(False)
    free = [run(), run()]
    torch.cuda.synchronize()
    names = ["y", "aux", "dx", "drouter", "dw_gate", "dw_up", "dw_down"]
    det_equal = [n for n, u, v in zip(names, *det) if not torch.equal(u, v)]
    free_equal = [n for n, u, v in zip(names, *free) if not torch.equal(u, v)]
    finite = all(bool(torch.isfinite(t).all()) for t in det[0])
    fwd_ms = cuda_ms(lambda: moe.moe_block(x, *weights, moe=cfg.moe),
                     iters=10)
    step_ms = cuda_ms(run, iters=5)
    cap = moe.capacity_for(b * s, cfg.moe)
    flops = 3 * 2 * e * cap * d * f
    ok = not det_equal and finite
    say("moe", f"{MOON} block, {b * s} tokens, {e} experts top "
        f"{cfg.moe.experts_per_token}, capacity {cap}: two forward + backward"
        f" calls under deterministic algorithms bit-equal in every output "
        f"and gradient: {not det_equal} {det_equal or ''}; without them: "
        f"{not free_equal} {free_equal or ''}; finite {finite}; forward "
        f"{fwd_ms:.3f} ms (its expert products {flops / 1e12:.3f} TFLOP at "
        f"{flops / fwd_ms / 1e9:.1f} TFLOP/s over the whole block), forward"
        f" + backward {step_ms:.3f} ms, on {card} {'ok' if ok else 'FAIL'}")
    profile_window(f"{MOON} moe block forward + backward", run, card,
                   grad=True, top=10, scopes=MOE_SCOPES)
    if not ok:
        fail("moe", "the MoE block is not bit-equal from call to call")


def fingerprints(*trees) -> list[tuple[str, int, int]]:
    """An exact function of each leaf's bits, per leaf and computed on the
    card: the raw bits as integers, their sum and their sum weighted by
    position (mod 2^64). Any changed bit changes the first; moved values
    change the second."""
    import torch
    from repro_torch.ckpt.checkpoint import flat_with_names
    as_int = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    out = []
    for ti, tree in enumerate(trees):
        for name, t in flat_with_names(tree):
            bits = t.detach().reshape(-1).view(as_int[t.element_size()])
            total = weighted = 0
            for lo in range(0, bits.numel(), 1 << 26):
                x = bits[lo:lo + (1 << 26)].long()
                w = torch.arange(lo, lo + x.numel(), device=x.device) % 65521 + 1
                total += int(x.sum())
                weighted += int((x * w).sum())
            out.append((f"t{ti}{name}", total, weighted))
    return out


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_resume(card: str) -> int:
    """qwen2.5-3b at full width under deterministic algorithms: RESUME_STEPS
    uninterrupted steps (run A) against RESUME_SAVE_AT steps, a striped
    save, and a fresh model resumed from it for the rest (run B), bit for
    bit; then the checkpoint served through ServeEngine.from_checkpoint.
    Returns the deterministic backward's launches over the phase."""
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.dfs.hdfs import HdfsCluster
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.loop import train_loop

    from repro_torch.tune.profile import get_active_profile

    if get_active_profile() is not None:
        fail("resume", "a tuning profile is active")
    say("resume", "no tuning profile is active: every kernel runs its "
        "default launch config, and the bit-equality gate is unchanged")
    cfg = get_config(QWEN)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    free = shutil.disk_usage(build_dir).free
    if free < RESUME_DISK_BYTES:
        fail("resume", f"{free / 1e9:.1f} GB free under {build_dir}, the "
             f"checkpoint needs {RESUME_DISK_BYTES / 1e9:.0f} GB")
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    free_card()
    torch.use_deterministic_algorithms(True)
    workdir = Path(tempfile.mkdtemp(prefix="resume-", dir=build_dir))
    try:
        def train(model, steps, log_fn=lambda _: None, **kw):
            return train_loop(model, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                              steps=steps, log_every=1, log_fn=log_fn, **kw)

        t0 = time.perf_counter()
        stamps = [t0]   # each step's loss is read when it ends
        params, opt, hist_a = train(Model(cfg, device="cuda"), RESUME_STEPS,
                                    log_fn=lambda _: stamps.append(
                                        time.perf_counter()))
        want = fingerprints(params, opt)
        steps_ms = [1e3 * (b - a) for a, b in zip(stamps[1:], stamps[2:])]
        say("resume", f"run A: {RESUME_STEPS} steps from seed 0, losses "
            f"{[h['loss'] for h in hist_a]}; steps 2-{RESUME_STEPS} under "
            f"deterministic algorithms {', '.join(f'{t:.1f}' for t in steps_ms)}"
            f" ms (median {statistics.median(steps_ms):.1f} ms; [train]'s "
            f"fast path above), on {card}")
        del params, opt
        free_card()

        ck = Checkpointer(HdfsCluster(workdir / "hdfs", throttle=None))
        params, opt, hist_b = train(Model(cfg, device="cuda"),
                                    RESUME_SAVE_AT, checkpointer=ck,
                                    ckpt_every=RESUME_SAVE_AT)
        saved = ck.timings
        say("resume", f"run B: {RESUME_SAVE_AT} steps, then saved step "
            f"{RESUME_SAVE_AT}: {saved['save_bytes']} bytes "
            f"({saved['save_bytes'] / 1e9:.2f} GB) in {saved['save_s']:.2f} s"
            f" = {saved['save_bytes'] / saved['save_s'] / 1e9:.2f} GB/s "
            f"(card -> pinned host -> CRC -> {ck.width} stripe files; of "
            f"which copies from the card {saved['save_copy_s']:.2f} s, "
            f"writes {saved['save_write_s']:.2f} s, waits on the CRCs "
            f"{saved['save_crc_wait_s']:.2f} s), on {card}")
        # the serving reference: an engine from the saved tensors directly
        del opt
        model = Model(cfg, device="cuda")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LENS[1])
                   .astype(np.int32) for _ in range(BATCH)]
        toks = {"tokens": torch.from_numpy(np.stack(prompts)).cuda()}
        engine = ServeEngine(model, model.serving_params(params), batch=BATCH,
                             cache_len=CACHE_LEN, device="cuda")
        direct = engine._prefill(engine.params, toks,
                                 unembed=engine.unembed)[0].cpu()
        del engine, params, model
        free_card()

        model = Model(cfg, device="cuda")
        first = []
        t0 = time.perf_counter()
        params, opt, hist_r = train_loop(
            model, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            steps=RESUME_STEPS - RESUME_SAVE_AT, checkpointer=ck,
            resume_from=RESUME_SAVE_AT, log_every=1,
            log_fn=lambda _: first or first.append(time.perf_counter()))
        ttfs = first[0] - t0
        got = fingerprints(params, opt)
        losses_a = [h["loss"] for h in hist_a]
        losses_b = [h["loss"] for h in hist_b + hist_r]
        r = ck.timings
        say("resume", f"resumed step {RESUME_SAVE_AT} into a fresh model: "
            f"wave 0 (params, CRITICAL) read {r['wave0_bytes'] / 1e9:.2f} GB "
            f"in {r['wave0_read_s']:.2f} s "
            f"({r['wave0_bytes'] / r['wave0_read_s'] / 1e9:.2f} GB/s) into "
            f"a pinned ring (allocated and page-locked in "
            f"{r['wave0_alloc_s']:.2f} s), its copies to the card "
            f"overlapped, the last waited {r['wave0_copy_s']:.2f} s; tail "
            f"(AdamW state, DEFERRED) {r['tail_bytes'] / 1e9:.2f} GB in "
            f"{r['tail_s']:.2f} s ({r['tail_bytes'] / r['tail_s'] / 1e9:.2f} "
            f"GB/s, read and copied alike); time to first step "
            f"after resume {ttfs:.2f} s (train_loop entry to the end of "
            f"step {RESUME_SAVE_AT}); page cache: the files were just "
            f"written, on {card}")
        say("resume", f"losses A {losses_a}")
        say("resume", f"losses B {losses_b}")
        differ = [a[0] for a, b in zip(want, got) if a != b]
        ok = losses_a == losses_b and not differ and len(want) == len(got)
        say("resume", f"{len(want)} leaves of params and AdamW state "
            f"bit-equal between A and B: {not differ} (differing: "
            f"{differ[:5]}); losses bit-equal: {losses_a == losses_b} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("resume", "the resumed run differs from the uninterrupted "
                 "one")
        del params, opt
        free_card()

        t0 = time.perf_counter()
        engine = ServeEngine.from_checkpoint(model, ck, RESUME_SAVE_AT,
                                             batch=BATCH, cache_len=CACHE_LEN)
        t1 = time.perf_counter()
        engine.generate([Request(prompt=p, max_new_tokens=0)
                         for p in prompts])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        restored = engine._prefill(engine.params, toks,
                                   unembed=engine.unembed)[0].cpu()
        same = torch.equal(restored, direct)
        r = ck.timings
        say("resume", f"serve: from_checkpoint read {r['wave0_bytes'] / 1e9:.2f}"
            f" GB of fp32 params in {r['wave0_read_s']:.2f} s (ring "
            f"{r['wave0_alloc_s']:.2f} s, last copy waited "
            f"{r['wave0_copy_s']:.2f} s), engine built in {t1 - t0:.2f} s; "
            f"time to first token from the cold restore {t2 - t0:.2f} s "
            f"(restore, cast, prefill of {BATCH} x {PROMPT_LENS[1]} and the "
            f"first token); prefill logits bit-equal to an engine's built "
            f"from the saved tensors: {same} {'ok' if same else 'FAIL'}, on "
            f"{card}")
        if not same:
            fail("resume", "from_checkpoint's prefill differs from the saved "
                 "tensors'")
        del engine
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(workdir, ignore_errors=True)
        free_card()
    counts = {name: fn.launches for name, fn in counters.items()}
    say("resume", f"kernel launches over the phase: {counts}")
    if counts["flash_attention_bwd"] or not counts[
            "flash_attention_bwd_deterministic"]:
        fail("resume", "the steps did not run the deterministic backward")
    return counts["flash_attention_bwd_deterministic"]



def run_launcher(tag: str, args: list[str], phase: str = "boot") -> dict:
    """Runs ``python -u args`` (PYTHONPATH=src) as a fresh process,
    echoing its output under ``[phase]`` and the time since the launch at
    which each line arrived; kills it after BOOT_CHILD_TIMEOUT_S. Returns
    its exit code, its lines with their arrival times, and its ``boot:``,
    ``boot-end:``, ``witness-report:`` and ``kernels:`` lines parsed."""
    import threading
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(BOOT_CHILD_TIMEOUT_S, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            lines.append((time.perf_counter() - t0, line))
            say(phase, f"  {tag} {lines[-1][0]:7.2f}s | {line}")
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"rc": rc, "lines": lines, "wall_s": time.perf_counter() - t0}
    for t, line in lines:
        for key in ("boot", "boot-end", "witness-report"):
            if line.startswith(key + ": "):
                out[key] = json.loads(line[len(key) + 2:])
                out[key + "_at"] = t
        if line.startswith("kernels: "):
            out["sha256"] = line.rsplit(" ", 1)[-1]
            out["library_dir"] = line.split(" loaded from ")[1].split(" in ")[0]
            out["kernels_at"] = t
    return out


def first_line(run: dict, prefix: str) -> tuple[float, str] | None:
    return next(((t, line) for t, line in run["lines"]
                 if line.startswith(prefix)), None)


def report_boot(tag: str, run: dict, first: tuple[float, str] | None,
                what: str, card: str) -> None:
    """One boot's stages, critical path, scheduler bytes and walls."""
    b, end = run["boot"], run["boot-end"]
    io = {res: end["io_bytes"].get(res, {}) for res in ("dfs", "registry",
                                                        "peer")}
    stages = ", ".join(f"{k} {v:.3f}" for k, v in b["stages_s"].items())
    say("boot", f"{tag}: runtime stages (slowest node) {stages}, total_s "
        f"{b['total_s']:.3f} s; critical path {' -> '.join(b['critical_path'])}"
        f" (tasks {', '.join(f'{k} {v:.3f}' for k, v in b['tasks_s'].items())}"
        f" s); prefetch_used {b['prefetch_used']}; nvcc in env.install "
        f"{b['nvcc_builds']}, after the runtime "
        f"{end['nvcc_builds'][len(b['nvcc_builds']):]}, on {card}")
    say("boot", f"{tag}: I/O scheduler bytes, CRITICAL / DEFERRED: "
        + "; ".join(f"{res} {v.get('critical', 0)} / {v.get('deferred', 0)}"
                    for res, v in io.items())
        + f" (after drain_deferred; at the TRAINING mark dfs "
        f"{b['io_bytes'].get('dfs', {}).get('critical', 0)} / "
        f"{b['io_bytes'].get('dfs', {}).get('deferred', 0)})")
    t_main = first_line(run, "launcher:")[0]
    t_start = first_line(run, "== startup")[0]
    t_total = run["boot_at"]
    t_lib = run.get("kernels_at", t_total)
    say("boot", f"{tag}: wall from the launch: {t_main:.2f} s to the "
        f"launcher's first line (the interpreter, imports), {t_start:.2f} s "
        f"to the runtime's start (registry, image, DFS, checkpoint "
        f"lookup), runtime {b['total_s']:.2f}"
        f" s, TRAINING mark at {t_total:.2f} s; then the library loaded at "
        f"{t_lib:.2f} s; {what} at {first[0]:.2f} s ({first[0] - t_lib:.2f}"
        f" s after the library: model, restore onto the card, the first "
        f"{'step' if 'step' in what else 'prefill'}); exit at "
        f"{run['wall_s']:.2f} s, on {card}")


def phase_boot(card: str) -> None:
    """The launchers booting through the BootSeer runtime, cold and warm,
    each in a fresh process at full width."""
    import torch
    free_card()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    free = shutil.disk_usage(build_dir).free
    if free < RESUME_DISK_BYTES:
        fail("boot", f"{free / 1e9:.1f} GB free under {build_dir}, the "
             f"training boot's checkpoint needs "
             f"{RESUME_DISK_BYTES / 1e9:.0f} GB")
    say("boot", f"this process holds {torch.cuda.memory_reserved() / 1e9:.2f}"
        f" GB of the card; the launchers run as fresh processes")
    train_dir = Path(tempfile.mkdtemp(prefix="boot-train-", dir=build_dir))
    serve_dir = Path(tempfile.mkdtemp(prefix="boot-serve-", dir=build_dir))
    try:
        runs = {}
        for tag, steps in (("train cold", 2), ("train warm", 1)):
            runs[tag] = run_launcher(
                tag, ["-m", "repro_torch.launch.train", *BOOT_TRAIN_ARGS,
                      "--steps", str(steps), "--workdir", str(train_dir)])
        lib = train_dir / "rt" / runs["train warm"].get("library_dir", "")
        control = run_launcher(
            "resume alone", ["-c", RESUME_ALONE, str(train_dir), str(lib),
                             QWEN, str(TRAIN_BATCH), str(TRAIN_SEQ)])
        witnessed = run_launcher(
            "witnessed", ["-m", "repro_torch.analysis.witness",
                          "repro_torch.launch.train", *BOOT_TRAIN_ARGS,
                          "--steps", "1", "--workdir", str(train_dir)],
            phase="witness")
        for tag in ("serve cold", "serve warm"):
            runs[tag] = run_launcher(
                tag, ["-m", "repro_torch.launch.serve", *BOOT_SERVE_ARGS,
                      "--workdir", str(serve_dir)])
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
        shutil.rmtree(serve_dir, ignore_errors=True)
    for tag, run in runs.items():
        if run["rc"] != 0 or "boot" not in run or "boot-end" not in run:
            fail("boot", f"{tag}: exit code {run['rc']}, see its lines above")
    if control["rc"] != 0 or first_line(control, "first step") is None:
        fail("boot", f"resume alone: exit code {control['rc']}")

    problems = []

    def gate(ok: bool, what: str) -> None:
        if not ok:
            problems.append(what)

    for kind in ("train", "serve"):
        cold, warm = runs[f"{kind} cold"], runs[f"{kind} warm"]
        gate(cold["boot"]["prefetch_used"] is False,
             f"{kind} cold: prefetch_used")
        gate(warm["boot"]["prefetch_used"] is True,
             f"{kind} warm: no prefetch")
        gate(len(cold["boot"]["nvcc_builds"]) == 1
             and cold["boot-end"]["nvcc_builds"] == cold["boot"]["nvcc_builds"],
             f"{kind} cold: nvcc did not run exactly once, inside env.install")
        gate(warm["boot-end"]["nvcc_builds"] == [],
             f"{kind} warm: nvcc ran")
        gate(cold.get("sha256") is not None
             and warm.get("sha256") == cold.get("sha256"),
             f"{kind} warm: the library differs from the cold run's")
    cold, warm = runs["train cold"], runs["train warm"]
    saved = first_line(cold, "  checkpoint @ step 2 (full")
    gate(saved is not None, "train cold: step 2 not saved")
    gate(first_line(warm, "resuming params/opt from step 2") is not None,
         "train warm: did not resume from step 2")
    from repro_torch.configs import get_config
    layers = get_config(QWEN).num_layers
    ssd_layers = get_config(MAMBA).num_layers
    launches = warm["boot-end"]["launches"]
    chunks = loss_launches(get_config(QWEN), TRAIN_BATCH, TRAIN_SEQ)
    gate(launches == {"flash_attention": 2 * layers,
                      "flash_attention_bwd": layers,
                      "flash_attention_bwd_deterministic": 0,
                      "ssd_chunked_kernel": 0, "ssd_chunked_bwd_kernel": 0,
                      "ssd_chunked_kernel_bf16": 0,
                      "ssd_chunked_bwd_kernel_bf16": 0,
                      "ce_fold_kernel": chunks["ce_fold"],
                      "ce_grad_kernel": chunks["ce_grad"]},
         f"train warm: launches {launches}")
    done = first_line(warm, "done: loss")
    loss = float(done[1].split()[4]) if done else float("nan")
    gate(math.isfinite(loss), f"train warm: loss {loss}")
    for tag in ("serve cold", "serve warm"):
        end = runs[tag]["boot-end"]
        gate(end["launches"]["ssd_chunked_kernel"]
             == ssd_layers * end["prefills"]
             and sum(end["launches"].values())
             == end["launches"]["ssd_chunked_kernel"],
             f"{tag}: launches {end['launches']} over {end['prefills']} "
             f"prefills, expected {ssd_layers} SSD launches each")
        gate(first_line(runs[tag], "first token") is not None,
             f"{tag}: no first token")
    tokens = [runs[t]["boot-end"]["greedy_tokens"]
              for t in ("serve cold", "serve warm")]
    gate(tokens[0] == tokens[1] and all(tokens[0]),
         f"serve: greedy tokens cold {tokens[0]} warm {tokens[1]}")

    for tag, run in runs.items():
        first = first_line(run, "step" if tag.startswith("train")
                           else "first token")
        report_boot(tag, run, first, "first step ended" if
                    tag.startswith("train") else "first token", card)
    # what the warm boot's reads of the checkpoint cost the restore beside
    # them: from "resuming" to the first step, against the control's
    spans = {}
    for tag, run in (("warm boot", warm), ("resume alone", control)):
        t_resume = first_line(run, "resuming params/opt")[0]
        t_step = first_line(run, "step")[0]
        spans[tag] = t_step - t_resume
        parts = "; ".join((first_line(run, p) or (0, f"no {p} line"))[1]
                          for p in ("card:", "restore:", "first step:",
                                    "parts:"))
        say("boot", f"{tag}: {t_step - t_resume:.2f} s from 'resuming' to "
            f"the first step ended; {parts}; on {card}")
    say("boot", f"the runtime's reads of the checkpoint beside the restore "
        f"cost {spans['warm boot'] - spans['resume alone']:.2f} s of the "
        f"warm boot's time to its first step, on {card}")
    say("boot", f"train cold: {saved[1].strip() if saved else 'no save'}; "
        f"train warm: {done[1] if done else 'no done line'}; launches "
        f"{launches}; library sha256 {warm.get('sha256')} in both; serve "
        f"greedy tokens equal cold/warm: {tokens[0] == tokens[1]}")
    if problems:
        fail("boot", "; ".join(problems))
    say("boot", "ok")
    check_witness(witnessed, layers, card)


def check_witness(run: dict, layers: int, card: str) -> None:
    """[witness]: the warm full-width training boot that ran under the
    port's lock witness and I/O witness (``python -m
    repro_torch.analysis.witness``, installed before the port's imports):
    no lock-order cycle, no byte that accounting missed, no priority
    inversion, and the step through the flash kernels."""
    report, end = run.get("witness-report"), run.get("boot-end")
    if report is None or end is None:
        fail("witness", f"exit code {run['rc']} and no report, see the "
             "lines above")
    locks, io = report["locks"], report["io"]
    launches = end["launches"]
    dfs = io["sched_bytes_by_resource"].get("dfs", {})
    say("witness", f"locks witnessed {locks['locks_witnessed']}, observed "
        f"edges {len(locks['observed_edges'])}, cycles "
        f"{len(locks['cycles'])} (static graph's roots src/repro_torch); "
        f"static gap {len(locks['static_gap'])}, possibly stale "
        f"{len(locks['possibly_stale'])}")
    say("witness", f"DFS bytes by priority: critical "
        f"{dfs.get('critical', 0)}, deferred {dfs.get('deferred', 0)} "
        f"(scheduler-metered); observed read {io['observed_read']} B, "
        f"accounted {io['accounted_read']} B; observed write "
        f"{io['observed_write']} B, accounted {io['accounted_write']} B")
    say("witness", f"unaccounted bytes read {io['unaccounted_read']}, "
        f"written {io['unaccounted_write']}; priority inversions "
        f"{len(io['inversions'])} in {io['slot_grants']} slot grants")
    say("witness", f"kernel launches {launches}; the run's wall "
        f"{run['wall_s']:.2f} s (not a boot timing), on {card}")
    problems = []
    if locks["cycles"]:
        problems.append(f"lock-order cycles {locks['cycles']}")
    if io["unaccounted_read"] or io["unaccounted_write"]:
        problems.append(f"unaccounted bytes read {io['unaccounted_read']}, "
                        f"written {io['unaccounted_write']}")
    if io["inversions"]:
        problems.append(f"priority inversions {io['inversions']}")
    if not (launches["flash_attention"] == 2 * layers
            and launches["flash_attention_bwd"] == layers):
        problems.append(f"flash launches {launches}, expected "
                        f"{2 * layers} forward and {layers} backward")
    if not dfs.get("critical"):
        problems.append("no DFS byte read at CRITICAL: the boot restored "
                        "nothing through the scheduler")
    if run["rc"] != 0:
        problems.append(f"exit code {run['rc']}")
    if problems:
        fail("witness", "; ".join(problems))
    say("witness", "ok")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        out = fn(*args)
        say("time", f"{name} ended {time.perf_counter() - t0:.1f} s after "
            "the start")
        return out

    card = timed("device", phase_device)
    timed("build", phase_build)
    flash = timed("kernels flash", phase_kernels, card)
    ssd = timed("kernels ssd", phase_ssd_kernels, card)
    ssd_bwd = timed("kernels ssd_bwd", phase_ssd_bwd_kernels, card)
    ssd_bf16, ssd_bwd_bf16, knob_budget = timed(
        "ssd knobs kernels", phase_ssd_knobs_kernels, card)
    flash_bwd, flash_bwd_det = timed("kernels flash_bwd",
                                     phase_flash_bwd_kernels, card)
    ce_fold, ce_grad = timed("kernels unembed_ce", phase_unembed_ce_kernels,
                             card)
    timed("tune kernels", phase_tune_kernels, card)
    profile = timed("tune boot", phase_tune_boot, card)
    archs = (QWEN, MAMBA, ZAMBA, MOON, AUDIO, VLM)
    timed("moe block", phase_moe_block, card)
    for arch in archs + (MIXTRAL,):
        timed(f"reference {arch}", phase_small_reference, card, arch)
    # the forward kernels' launches over the serving paths, the backward
    # kernels' over the training paths
    served = [timed(f"serve {arch}", phase_serve, card, arch,
                    profile if arch in TUNED_SERVE else None)
              for arch in archs]
    for entry in (flash, ssd):
        entry["launches"] = sum(c[entry["name"]] for c in served)
        entry["config_launches"] = {}
        for c in served:
            for config, n in c["configs"][entry["name"]].items():
                entry["config_launches"][config] = \
                    entry["config_launches"].get(config, 0) + n
    for arch in archs + (MIXTRAL,):
        timed(f"reference train {arch}", phase_small_train_reference, card,
              arch)
    trained = [timed(f"train {arch}", phase_train, card, arch,
                     profile if arch == AUDIO else None)
               for arch in archs]
    for entry in (flash_bwd, ssd_bwd, ce_fold, ce_grad):
        entry["launches"] = sum(c[entry["name"]] for c in trained)
    knob_launches = timed("ssd knobs model", phase_ssd_knobs_model, card,
                          knob_budget)
    for entry in (ssd_bf16, ssd_bwd_bf16):
        entry["launches"] = knob_launches[entry["name"]]
    timed("shard kernels", phase_shard_kernels, card)
    timed("shard model", phase_shard_model, card)
    flash_bwd_det["launches"] = timed("resume", phase_resume, card)
    timed("boot", phase_boot, card)
    print(json.dumps({"kernels": [flash, ssd, flash_bwd, flash_bwd_det,
                                  ssd_bwd, ssd_bf16, ssd_bwd_bf16, ce_fold,
                                  ce_grad]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
