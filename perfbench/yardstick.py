"""The benchmark's yardstick, kept apart from the program so that it does
not move with it: the card's peaks, the least work of the kernels' calls
and of a training step, counted from the configuration and the shapes, and
the reading of a profiler trace.

The formulas are frozen copies of the program's ``roofline/kernel_cost.py``
(the SSD scan's ``ssd_flops`` and ``ssd_bwd_flops``, each input read once
and each output written once) and of the model-FLOPs arithmetic of
``chip_smoke.py``'s training phase (6 N T, N outside the embedding); what
a step adds beyond 6 N T is counted by its architecture's reference module
(``perfbench/reference/<arch_type>.py``'s ``step_flops``).
"""

from __future__ import annotations

from collections import defaultdict

from perfbench.reference import architecture


# NVIDIA H100 SXM, data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# the SSD scan's chunk lengths over which its least work is taken
SSD_TILES = (16, 32, 64, 128, 256)


def ssd_fwd_flops(b, s, h, p, g, n, tile):
    """The chunked scan's work at chunk ``tile``: per (batch, group,
    chunk) the triangle of C B^T, 2 N a pair; per (batch, head, chunk) the
    triangle of M x, 2 P a pair; per token and head the carried state's
    term and the state update, 2 N P each."""
    tiles = -(-s // tile)
    pairs = tile * (tile + 1) // 2
    return (b * g * tiles * pairs * 2 * n + b * h * tiles * pairs * 2 * p
            + b * h * s * 4 * n * p)


def ssd_bwd_flops(b, s, h, p, g, n, tile):
    """The backward's work at chunk ``tile``: C B^T recomputed (2 N a
    pair, per group), the triangles of dy x^T, M^T dy and the dB, dC sums
    (2 P, 2 P, 2 N, 2 N a pair, per head), five [P, N] products a token and
    head (2 N P each)."""
    tiles = -(-s // tile)
    pairs = tile * (tile + 1) // 2
    return (b * g * tiles * pairs * 2 * n
            + b * h * tiles * pairs * (4 * p + 4 * n) + b * h * s * 10 * n * p)


def ssd_fwd_cost(b, s, h, p, g, n):
    """(least FLOPs over the chunk lengths, bytes): x, dt, B, C read and y
    (bf16 but dt) and the fp32 final state written."""
    flops = min(ssd_fwd_flops(b, s, h, p, g, n, t) for t in SSD_TILES)
    nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * g * n
              + 4 * b * h * p * n)
    return flops, nbytes


def ssd_bwd_cost(b, s, h, p, g, n):
    """(least FLOPs, bytes): x, dy, B, C, dt read, dx, dB, dC, ddt
    written (bf16 but dt and ddt)."""
    flops = min(ssd_bwd_flops(b, s, h, p, g, n, t) for t in SSD_TILES)
    nbytes = 3 * 2 * b * s * h * p + 4 * 2 * b * s * g * n + 2 * 4 * b * s * h
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def step_model_flops(cfg: dict, batch: int, seq: int, n_params: int) -> float:
    """Model FLOPs of one training step, recomputation not counted: 6 N T
    for the ``n_params`` parameters outside the embedding, and what the
    module of the configuration's architecture counts beyond it (its
    ``step_flops``)."""
    return 6.0 * n_params * batch * seq + architecture(cfg).step_flops(
        cfg, batch, seq)


# ----- reading a profiler trace -----

OPS = ("repro_torch::flash_attention_fwd", "repro_torch::flash_attention_bwd",
       "repro_torch::ssd_fwd", "repro_torch::ssd_bwd")


def _merge(intervals: list) -> list:
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Trace:
    """What one traced window shows, from ``torch.profiler``'s events:
    device busy seconds (the union of every device operation's interval:
    kernels, copies, sets), the window's host seconds, the kernels' time
    by name, the device time of the kernels launched inside each of the
    program's kernel operators with the calls' input shapes, and the
    longest idle gaps by what the host was doing then (the innermost of
    the benchmark's spans and the innermost host operation)."""

    def __init__(self, events, window_s: float, units: int):
        self.window_s = window_s
        self.units = units          # steps, or resumes, in the window
        device, host = [], []
        for e in events:
            if not _is_device(e):
                host.append(e)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith("bench.")):
                device.append(e)   # a span's mirror on the device is none
        spans = [(e.time_range.start, e.time_range.end) for e in device]
        merged = _merge(spans)
        self.busy_s = sum(hi - lo for lo, hi in merged) / 1e6
        self.kernel_s = defaultdict(float)
        for e in device:
            self.kernel_s[e.name] += (e.time_range.end
                                      - e.time_range.start) / 1e6
        # kernels alone, without the copies and sets
        self.kernels_s = sum(v for k, v in self.kernel_s.items()
                             if not k.startswith(("Memcpy", "Memset")))
        # the operators' calls: (name, input shapes, device seconds inside)
        self.op_calls = [(e.name, [list(s) for s in e.input_shapes],
                          _device_inside(e) / 1e6)
                         for e in host if e.name in OPS]
        self.gaps = self._gaps(merged, host)

    def op_seconds(self, names) -> float:
        return sum(s for n, _, s in self.op_calls if n in names)

    def calls(self, name: str) -> list:
        return [shapes for n, shapes, _ in self.op_calls if n == name]

    @staticmethod
    def _gaps(merged: list, host: list) -> dict:
        """Idle seconds between device operations, by label: a sweep over
        the gaps' midpoints, keeping the host spans that cover each."""
        by_label: dict = defaultdict(float)
        spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                        for e in host), key=lambda x: x[0])
        active: list = []
        i = 0
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            while i < len(spans) and spans[i][0] <= mid:
                active.append(spans[i])
                i += 1
            active = [sp for sp in active if sp[1] >= mid]
            bench = [sp for sp in active if sp[2].startswith("bench.")]
            other = [sp for sp in active if not sp[2].startswith("bench.")]
            label = (f"{max(bench)[2] if bench else 'outside spans'} / "
                     f"{max(other)[2] if other else 'python'}")
            by_label[label] += (b - a) / 1e6
        return by_label

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) in (
        "CUDA", "PrivateUse1")


def _device_inside(e) -> float:
    """Microseconds of device time of the kernels launched inside host
    event ``e`` (its children's included)."""
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0
