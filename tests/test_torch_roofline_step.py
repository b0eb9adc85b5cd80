"""The port's step-level roofline against the JAX package's, on the CPU:
``analyze`` and ``format_table`` (``src/repro/roofline/analysis.py``), the
count of a step (``roofline/step_cost.analytic_cost`` against the
reference's ``roofline/jaxpr_cost.analytic_cost`` of its jitted step, on
an Auto-axis mesh), the kernel operators' FLOPs on the meta device against
``roofline/kernel_cost.py``, the meta count outside the kernels against
the CPU's outside the plain versions, the operators' autograd, and the
model's host-side ring bookkeeping.

FLOPs: the port counts matmul-class work only; the reference counts
``dot_general`` and one FLOP per output element of every other equation.
The tests split the reference's walk (``_ref_split``, whose parts must
add up to its total) into contracted products, products with no
contracted dimension (outer products) and the rest, and hold the port to
the first to 1e-6 relative, less one gap computed apart: in a training
step of the SSM families, what JAX's backward of the SSD scan's outer
products contracts and torch's does not (``_ssd_backward_gap``). Every
other gap (the elementwise FLOPs, the outer products) is one the port
does not count by its convention. Bytes follow the same no-fusion
convention on both sides over different operator sets (the port's views
are free, the reference's reshapes and slices are not), so they are held
within a factor of 2 and their ratios printed.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro import compat
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.roofline import analysis as janalysis
from repro.roofline.jaxpr_cost import (_SUBJAXPR_KEYS, _dot_flops, _jaxpr_of,
                                       _nbytes, _nelems)
from repro.roofline.jaxpr_cost import jaxpr_cost
from repro.serve.step import jit_decode_step, jit_prefill
from repro.sharding.rules import make_rules
from repro.train.step import jit_train_step
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (_masked_scores, attention_lse_reference,
                                     ssd_backward_tiles,
                                     ssd_chunked_reference)
from repro_torch.kernels.ssd import TILE
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
from repro_torch.roofline import analysis
from repro_torch.roofline.kernel_cost import (ssd_bwd_flops, ssd_flops,
                                              unmasked_pairs)
from repro_torch.roofline.step_cost import analytic_cost
from repro_torch.serve.step import make_decode_step, make_prefill
from repro_torch.train.step import make_train_step

# one config of each family: dense, SSM, hybrid, MoE
FAMILIES = ("qwen2.5-3b", "mamba2-370m", "zamba2-1.2b", "moonshot-v1-16b-a3b")
KINDS = ("train", "prefill", "decode")
B, S = 2, 64
KERNEL_OPS = ("repro_torch.flash_attention_fwd",
              "repro_torch.flash_attention_bwd", "repro_torch.ssd_fwd",
              "repro_torch.ssd_bwd")
H100 = {"PEAK_FLOPS": analysis.PEAK_FLOPS, "HBM_BW": analysis.HBM_BW,
        "LINK_BW": analysis.LINK_BW}


@pytest.fixture(scope="module")
def jax_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return make_rules(mesh)


# ------------------------------------------------ analyze, format_table ---

def _reports(monkeypatch, cost: dict, kind: str, arch: str):
    """The port's and the reference's reports on the same inputs, the
    reference's constants set to the H100's."""
    for name, value in H100.items():
        monkeypatch.setattr(janalysis, name, value)
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    kw = dict(arch=arch, mesh_name="1", chips=1, step_kind=kind,
              collectives={"total": 3.0e9, "all-gather": 3.0e9},
              memory_per_device=5.5e10, notes="n")
    ours = analysis.analyze(shape=SHAPES[shape], cost=cost,
                            cfg=get_config(arch), **kw)
    ref = janalysis.analyze(shape=JSHAPES[shape], cost=cost,
                            cfg=jget_config(arch), **kw)
    return ours, ref


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("kind", KINDS)
def test_analyze_matches_the_reference(monkeypatch, arch, kind):
    """Without an fp32 share the report is the reference's, field by field
    (dict equality: every float bit-equal)."""
    cost = {"flops": 7.3e15, "bytes accessed": 2.1e13}
    ours, ref = _reports(monkeypatch, cost, kind, arch)
    assert ours.to_json() == ref.to_json()


def test_analyze_prices_fp32_gemms_at_the_fp32_rate(monkeypatch):
    """An fp32 share moves the compute term to bf16 / 989 T + fp32 / 67 T
    and nothing else."""
    cost = {"flops": 7.3e15, "flops_fp32": 1.3e15, "bytes accessed": 5e13}
    ours, ref = _reports(monkeypatch, cost, "train", "qwen2.5-3b")
    got, want = ours.to_json(), ref.to_json()
    assert got.pop("compute_s") == pytest.approx(
        6.0e15 / analysis.PEAK_FLOPS + 1.3e15 / analysis.PEAK_FP32_FLOPS,
        rel=1e-12)
    want.pop("compute_s")
    got.pop("bottleneck"), want.pop("bottleneck")
    assert got == want
    assert ours.bottleneck == "compute" and ref.bottleneck == "memory"


def test_format_table_matches_the_reference(monkeypatch):
    pairs = [_reports(monkeypatch, {"flops": f, "bytes accessed": b}, kind,
                      arch)
             for f, b, kind, arch in [(7.3e15, 2.1e13, "train", "yi-34b"),
                                      (1e12, 4e12, "decode", "mamba2-370m"),
                                      (0.0, 0.0, "prefill", "dbrx-132b")]]
    ours = analysis.format_table([p[0] for p in pairs])
    ref = janalysis.format_table([p[1] for p in pairs])
    assert ours == ref and len(ours.splitlines()) == 5


# --------------------------------------------- a step's count, vs JAX ---

# jaxpr equations that PyTorch runs as views of their operand (free in the
# port's count; the reference counts operand and result of each)
VIEW_PRIMITIVES = ("reshape", "squeeze", "expand_dims", "slice", "transpose",
                   "broadcast_in_dim")
SKIPPED = ("custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
           "remat", "remat2", "checkpoint", "closed_call", "core_call", "pjit")


def _ref_split(jaxpr) -> dict:
    """The reference's ``jaxpr_cost`` walk, its FLOPs split into
    ``dot_general``'s with a contracted dimension ("dot"), those without
    one ("outer": an outer product, 2 FLOPs an output element), and one a
    output element of every other equation ("rest"); and the bytes of the
    equations that are views in PyTorch ("view_bytes")."""
    acc = dict.fromkeys(("dot", "outer", "rest", "view_bytes"), 0.0)

    def add(part: dict, n: int = 1):
        for k, v in part.items():
            acc[k] += v * n

    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            acc["dot" if lc else "outer"] += _dot_flops(eqn)
            continue
        sub, n = None, 1
        if name == "scan":
            sub, n = _jaxpr_of(eqn.params["jaxpr"]), eqn.params["length"]
        elif name == "while":
            sub = _jaxpr_of(eqn.params["body_jaxpr"])
        elif name == "shard_map":
            sub = compat.shard_map_body(eqn.params)
            n = compat.shard_map_mesh_size(eqn.params)
        elif name == "cond":
            add(max((_ref_split(_jaxpr_of(br))
                     for br in eqn.params["branches"]),
                    key=lambda d: d["dot"] + d["outer"] + d["rest"]))
            continue
        else:
            sub = next((_jaxpr_of(eqn.params[k]) for k in _SUBJAXPR_KEYS
                        if k in eqn.params
                        and hasattr(_jaxpr_of(eqn.params[k]), "eqns")), None)
        if sub is not None:
            add(_ref_split(sub), n)
        elif name not in SKIPPED:
            acc["rest"] += sum(_nelems(v.aval) for v in eqn.outvars)
            if name in VIEW_PRIMITIVES:
                acc["view_bytes"] += sum(
                    _nbytes(v.aval) for v in (*eqn.invars, *eqn.outvars)
                    if hasattr(v, "aval"))
    return acc


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(tuple(shape), dtype)


def _ref_step(jm: JModel, kind: str):
    """The reference's jitted step at (B, S) and its ShapeDtypeStruct
    arguments: the JAX dry run's ``build_lowerable`` (fp32 masters, one
    decode token against an S cache), without importing it (it sets
    XLA_FLAGS for every JAX test after it in the process)."""
    pshapes = jm.param_shapes()
    tokens = _sds((B, S), jnp.int32)
    if kind == "train":
        fn = jit_train_step(jm, JAdamWConfig(), B)
        opt = {"mu": pshapes, "nu": pshapes, "step": _sds((), jnp.int32)}
        return fn, (pshapes, opt, {"tokens": tokens, "labels": tokens})
    if kind == "prefill":
        return jit_prefill(jm, B, S), (pshapes, {"tokens": tokens})
    caches = jax.tree.map(
        _sds, jm.cache_shapes(B, S), jm.cache_dtypes(B, S),
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(i, int) for i in x))
    return jit_decode_step(jm, B, S), (pshapes, _sds((B, 1), jnp.int32),
                                       caches, _sds((), jnp.int32))


def _port_step(m: Model, kind: str):
    """The port's step at (B, S) on the CPU, as the reference's is priced:
    fp32 masters for every kind, cast where used, and the unembedding
    table made inside each call."""
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, dtype=torch.float32)
    tokens = torch.randint(0, m.cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    if kind == "train":
        return make_train_step(m, AdamWConfig()), (
            params, adamw_init(params), {"tokens": tokens, "labels": tokens})
    if kind == "prefill":
        return make_prefill(m, B, S), (params, {"tokens": tokens})
    decode = make_decode_step(m, B, S)
    return (lambda p, t, c: decode(p, t, c, S - 1),
            (params, tokens[:, :1], m.init_cache(B, S)))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", KINDS)
def test_step_flops_match_the_reference(jax_rules, arch, kind):
    """The port's count of a tiny step on the CPU against the reference's
    ``analytic_cost`` of its jitted step (the forward, the backward and
    remat's recomputation, the router, the plain attention and SSD scan,
    the unembedding, AdamW). The reference's total is its contracted
    ``dot_general`` FLOPs, its outer products' and one FLOP per other
    output element; the port's FLOPs equal the first to 1e-6 relative,
    less, in an SSM family's training step, the SSD backward's gap. The
    other gaps: torch's einsum runs a product with no contracted dimension
    (the SSD scan's B x (x dt) terms) as a broadcast multiply, elementwise,
    which the port does not count, nor any other elementwise work. Bytes
    within a factor of 2 of the reference's less its equations that are
    views in PyTorch (the hybrid's per-layer slices of stacked leaves
    count the whole leaf there), both ratios printed."""
    jm = JModel(jreduced(jget_config(arch)), jax_rules)
    fn, args = _ref_step(jm, kind)
    # janalytic_cost(fn, *args), from one trace that _ref_split also walks
    closed = jax.make_jaxpr(fn)(*args)
    ref = dict(zip(("flops", "bytes"), jaxpr_cost(closed.jaxpr)))
    part = _ref_split(closed.jaxpr)
    assert part["dot"] + part["outer"] + part["rest"] == pytest.approx(
        ref["flops"], rel=1e-12)

    m = Model(reduced(get_config(arch)), device="cpu")
    port_fn, port_args = _port_step(m, kind)
    ours = analytic_cost(port_fn, *port_args)
    gap = abs(ours["flops"] - part["dot"]) / part["dot"]
    ratio = ours["bytes"] / (ref["bytes"] - part["view_bytes"])
    print(f"{arch} {kind}: port {ours['flops']:.6e} FLOPs (bf16 "
          f"{ours['flops_bf16']:.4e}, fp32 {ours['flops_fp32']:.4e}); "
          f"reference {ref['flops']:.6e} = contracted {part['dot']:.6e} + "
          f"outer {part['outer']:.6e} + elementwise {part['rest']:.6e} "
          f"({part['rest'] / ref['flops']:.2%}); bytes port / reference "
          f"{ours['bytes'] / ref['bytes']:.3f}, less its views {ratio:.3f}")
    explained = 0.0
    if m.cfg.ssm and kind == "train":
        explained = m.cfg.num_layers * _ssd_backward_gap(m.cfg)
    print(f"  the port's FLOPs {gap:.3e} below the contracted ones, "
          f"{explained / part['dot']:.3e} explained by the SSD backward")
    assert abs(part["dot"] - ours["flops"] - explained) <= 1e-6 * part["dot"]
    assert gap <= 1e-2
    assert ours["flops"] == ours["flops_bf16"] + ours["flops_fp32"]
    assert 0.5 <= ratio <= 2.0
    assert (part["outer"] > 0) == (m.cfg.ssm is not None)


def _ssd_backward_gap(cfg) -> float:
    """The reference's contracted FLOPs less the port's in one backward of
    the model's chunked SSD scan: JAX differentiates the scan's products
    with no contracted dimension into contracted ``dot_general``s, torch's
    autograd the broadcast multiplies they were into multiplies and sums
    (elementwise). Each side's backward is its VJP less its forward."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    shapes = [(B, S, h, s.head_dim), (B, S, h), (h,),
              (B, S, s.ngroups, s.state_dim), (B, S, s.ngroups, s.state_dim),
              (h,)]
    sds = [_sds(sh, jnp.float32) for sh in shapes]

    def jfwd(*a):
        return jssm.ssd_chunked(*a, chunk=s.chunk_size)

    def jloss(*a):
        return jfwd(*a).sum()

    ref = (_ref_split(jax.make_jaxpr(jax.grad(jloss, argnums=tuple(
        range(6))))(*sds).jaxpr)["dot"]
        - _ref_split(jax.make_jaxpr(jfwd)(*sds).jaxpr)["dot"])
    leaves = [torch.randn(sh, requires_grad=True) for sh in shapes]

    def fwd():
        return ssm.ssd_chunked(*leaves, chunk=s.chunk_size)

    port = (analytic_cost(lambda: fwd().sum().backward())["flops"]
            - analytic_cost(fwd)["flops"])
    return ref - port


# --------------------------------------------------- the meta device ---

def _shape(kind: str) -> ShapeConfig:
    return ShapeConfig(f"{kind}_{S}", S, B, kind)


def _meta_record(arch: str, kind: str) -> dict:
    return dryrun.run_one(arch, cfg=reduced(get_config(arch)),
                          shape=_shape(kind), verbose=False)


def _kernel_flops(cfg, kind: str) -> dict:
    """kernel_cost's formulas over one step's launches: a flash forward per
    attention call, an SSD forward per Mamba2 layer (twice in training:
    remat recomputes), and a backward of each in training."""
    calls = {"dense": cfg.num_layers, "moe": cfg.num_layers,
             "hybrid": -(-cfg.num_layers // max(cfg.shared_attention_every,
                                                1)),
             "ssm": 0}[cfg.arch_type]
    mamba = cfg.num_layers if cfg.ssm else 0
    if kind == "decode":
        return {}
    fwd = 2 if kind == "train" else 1
    out = {}
    if calls:
        pairs = unmasked_pairs(S, S, True, cfg.sliding_window or 0)
        per = B * cfg.num_heads * cfg.head_dim * pairs
        out["repro_torch.flash_attention_fwd"] = fwd * calls * 4 * per
        if kind == "train":
            out["repro_torch.flash_attention_bwd"] = calls * 10 * per
    if mamba:
        s = cfg.ssm
        shape = (B, S, s.expand * cfg.d_model // s.head_dim, s.head_dim,
                 s.ngroups, s.state_dim)
        out["repro_torch.ssd_fwd"] = fwd * mamba * ssd_flops(*shape,
                                                             tile=TILE)
        if kind == "train":
            out["repro_torch.ssd_bwd"] = mamba * ssd_bwd_flops(*shape)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_operators_flops_on_meta(arch, kind):
    """On the meta device the kernels run as their operators, once per
    launch the card would make, each priced by kernel_cost's formula."""
    rec = _meta_record(arch, kind)
    by_op = rec["cost_analytic_global"]["by_op"]
    got = {k: v["flops"] for k, v in by_op.items() if k in KERNEL_OPS}
    assert got == pytest.approx(_kernel_flops(reduced(get_config(arch)),
                                              kind), rel=1e-12)
    assert rec["cost"]["flops"] > 0 and rec["step_kind"] == kind


def _attention_stub(q, k, v, *, causal=True, window=0):
    """No matmul; the output depends on q, k and v, so their producers'
    backward runs as through the plain version."""
    return q + (k.sum(2, keepdim=True) + v.sum(2, keepdim=True)) * 0


def _ssd_stub(x, dt, A, B, C, D, *, chunk, compute_dtype=torch.float32):
    """No matmul; y depends on every input, as through the plain version."""
    b, s, h, p = x.shape
    zero = (dt.sum(-1) + B.sum((2, 3)) + C.sum((2, 3))
            + A.sum() + D.sum())[..., None, None] * 0
    return x + zero.to(x.dtype), x.new_zeros((b, h, p, B.shape[-1]),
                                             dtype=torch.float32)


def _materialize(tree):
    """Meta tensors as CPU ones: floats N(0, 0.02^2), integers zero."""
    def make(t):
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return t
        if t.is_floating_point():
            return (0.02 * torch.randn(t.shape)).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return tree_map(make, tree)


@pytest.mark.parametrize("arch", FAMILIES + ("qwen2-vl-72b",))
@pytest.mark.parametrize("kind", KINDS)
def test_meta_count_outside_the_kernels_is_the_cpus(monkeypatch, arch, kind):
    """The dry run's count less its kernel operators equals, dtype by
    dtype, the same step's count on the CPU with the plain versions
    replaced by matmul-free stand-ins: everything around the kernels is
    counted alike on both devices."""
    rec = _meta_record(arch, kind)
    by_op = rec["cost_analytic_global"]["by_op"]
    kernels = sum(v["flops"] for k, v in by_op.items() if k in KERNEL_OPS)
    meta = rec["cost_analytic_global"]

    cpu_model = Model(reduced(get_config(arch)), device="cpu")
    fn, args, _ = dryrun.build_step(cpu_model, _shape(kind))
    monkeypatch.setattr(model_mod, "attention_op", _attention_stub)
    monkeypatch.setattr(model_mod, "ssd_op", _ssd_stub)
    cpu = analytic_cost(fn, *_materialize(args))
    assert meta["flops_fp32"] == cpu["flops_fp32"]
    assert meta["flops_bf16"] - kernels == cpu["flops_bf16"]
    assert not any(k in KERNEL_OPS for k in cpu["by_op"])


def test_meta_tensors_take_the_default_config_under_a_profile():
    """A meta tensor names no card: no profile is consulted."""
    from repro_torch.tune import TuningProfile
    from repro_torch.tune.profile import use_profile
    q = torch.empty((2, 128, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    prof = TuningProfile(backend="cuda-sm_90a:any card")
    h0 = dict(ops.stats)
    with use_profile(prof):
        assert ops.attention_config(q, kv, causal=True, window=0) == \
            ops.DEFAULT_ATTENTION
        out = ops.attention_op(q, kv, kv)
    assert out.shape == q.shape and out.device.type == "meta"
    assert ops.stats == h0 and prof.stats["misses"] == 0


# ------------------------------------------ the operators' autograd ---

def _attention_grads(q, k, v, do, causal, window, q_offset=0):
    """dq, dk, dv of the plain attention in fp32, model layout, by the
    backward's formulas (a kernel implementation runs below autograd, so
    it cannot call it): dV = P^T dO, dS = P o (dP - rowsum(dP o P)),
    dQ = dS K / sqrt(d), dK = dS^T Q / sqrt(d), dK and dV summed over
    each kv head's group."""
    qt, kt, vt, dot = (t.transpose(1, 2).float() for t in (q, k, v, do))
    b, hq, sq, d = qt.shape
    hkv = kt.shape[1]
    qg, dog = (t.reshape(b, hkv, hq // hkv, sq, d) for t in (qt, dot))
    p = torch.softmax(_masked_scores(qt, kt, causal, window, q_offset),
                      dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vt)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(d)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kt).reshape(b, hq, sq, d)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return tuple(g.transpose(1, 2).to(t.dtype).contiguous()
                 for g, t in zip((dq, dk, dv), (q, k, v)))


@pytest.fixture()
def plain_kernels():
    """The kernel operators given CPU implementations within the test
    (a library scoped to it: afterwards a CPU call finds no kernel): the plain
    forwards, and the backwards without autograd (the formulas above; the
    SSD backward kernel's algorithm, ``ssd_backward_tiles``); records each
    backward call's deterministic flag or workspace size."""
    calls = []

    def flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k,
                  return_lse):
        out, lse = attention_lse_reference(
            *(t.transpose(1, 2) for t in (q, k, v)), causal=causal,
            window=window, q_offset=q_offset)
        return (out.transpose(1, 2).contiguous(),
                lse if return_lse else q.new_empty((0,), dtype=torch.float32))

    def flash_bwd(q, k, v, lse, do, causal, window, q_offset, deterministic):
        calls.append(("flash_attention_bwd", deterministic))
        return _attention_grads(q, k, v, do, causal, window, q_offset)

    def ssd_fwd(x, dt, A, B, C, D, chunk, bf16_intra=False):
        return ssd_chunked_reference(x, dt, A, B, C, D, chunk=chunk)

    def ssd_bwd(x, dt, A, B, C, D, dy, workspace, bf16_intra=False):
        calls.append(("ssd_bwd", workspace.numel()))
        return ssd_backward_tiles(x, dt, A, B, C, D, dy)

    with torch.library._scoped_library("repro_torch", "IMPL") as lib:
        for name, fn in (("flash_attention_fwd", flash_fwd),
                         ("flash_attention_bwd", flash_bwd),
                         ("ssd_fwd", ssd_fwd), ("ssd_bwd", ssd_bwd)):
            lib.impl(name, fn, "CPU")
        yield calls


def _grads(fn, leaves, dout):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    torch.autograd.backward(fn(*leaves), dout)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("window", [0, 24])
def test_flash_operator_autograd_gives_the_plain_gradients(plain_kernels,
                                                           window):
    """Through the forward operator's registered autograd (the LSE saved,
    the backward operator called, with the deterministic flag under
    PyTorch's switch) the gradients are autograd's through the plain
    version on the same fp32 inputs; two calls bit-equal."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 16), generator=gen)
    k, v = (torch.randn((2, 40, 2, 16), generator=gen) for _ in range(2))
    do = torch.randn(q.shape, generator=gen)

    def plain(q, k, v):
        return ops.attention_op(q, k, v, window=window)

    def through_op(q, k, v):
        return ops.flash_attention_fwd_op(q, k, v, True, window, 0, 128,
                                          64, True)[0]

    want = _grads(plain, (q, k, v), do)
    got = _grads(through_op, (q, k, v), do)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        again = _grads(through_op, (q, k, v), do)
    finally:
        torch.use_deterministic_algorithms(was)
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        assert torch.equal(g, a)
    assert plain_kernels == [("flash_attention_bwd", False),
                             ("flash_attention_bwd", True)]


def test_ssd_operator_autograd_gives_the_plain_gradients(plain_kernels):
    """Through the SSD forward operator's autograd: the six gradients of
    the plain version, the workspace allocated by the caller at the
    library's size, and a gradient reaching the final state refused."""
    gen = torch.Generator().manual_seed(1)
    b, s, h, p, g, n = 2, 70, 4, 16, 2, 8
    x = torch.randn((b, s, h, p), generator=gen)
    dt = 0.001 + 0.1 * torch.rand((b, s, h), generator=gen)
    A = -(1 + 15 * torch.rand((h,), generator=gen))
    Bm, Cm = (torch.randn((b, s, g, n), generator=gen) for _ in range(2))
    D = torch.randn((h,), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    leaves = (x, dt, A, Bm, Cm, D)

    def plain(*t):
        return ssd_chunked_reference(*t, chunk=TILE)[0]

    def through_op(*t):
        return ops.ssd_fwd_op(*t, TILE)[0]

    want = _grads(plain, leaves, dy)
    got = _grads(through_op, leaves, dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    tiles = -(-s // TILE)
    assert plain_kernels == [("ssd_bwd", 2 * b * h * tiles * (p * n + 1))]
    y, state = ops.ssd_fwd_op(*[t.clone().requires_grad_() for t in leaves],
                              TILE)
    with pytest.raises(NotImplementedError, match="final state"):
        (y.sum() + state.sum()).backward()


# ------------------------------------------- host-side bookkeeping ---

def _old_ring(s: int, w: int):
    """The ring's (slots, source positions) as prefill computed them before,
    through a data-dependent ``nonzero``."""
    p0 = max(0, s - w)
    src = p0 + torch.remainder(torch.arange(w) - p0, w)
    valid = src < s
    return valid.nonzero()[:, 0], src[valid]


@pytest.mark.parametrize("cache_len", [128, 100, 64, 33])
def test_prefill_ring_bookkeeping_is_bit_equal(cache_len):
    """The ring's slots and positions from arange alone equal the nonzero
    ones; a prefill into a ring that wraps holds, slot by slot, the bits
    of the same positions in a ring that does not, and equal logits."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")),
                              dtype="float32")
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    s = 100
    tokens = torch.randint(0, cfg.vocab_size, (2, s),
                           generator=torch.Generator().manual_seed(1))
    for w in (s - 1, s, s + 1, 64, 33, 7):
        slots, src = _old_ring(s, w)
        assert torch.equal(slots, torch.arange(min(s, w)))
        assert torch.equal(src, max(0, s - w) + torch.remainder(
            torch.arange(min(s, w)) - max(0, s - w), w))
    big_logits, big = m.prefill(params, {"tokens": tokens}, cache_len=128)
    logits, ring = m.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    assert torch.equal(logits, big_logits)
    w = m.cache_window(cache_len)
    slots, src = _old_ring(s, w)
    want = torch.full((cfg.num_layers, w), -1, dtype=torch.int32)
    want[:, slots] = src.to(torch.int32)
    assert torch.equal(ring["slot_pos"], want)
    for name in ("k", "v"):
        assert torch.equal(ring[name][:, :, slots], big[name][:, :, src])


@pytest.mark.parametrize("sections", [(16, 24, 24), (8, 12, 12), (2, 3, 3),
                                      (0, 4, 4)])
def test_mrope_streams_from_the_host_are_bit_equal(sections):
    """M-RoPE's stream of each frequency slot, from the section bounds on
    the host, gives repeat_interleave's rotation bit for bit."""
    half = sum(sections)
    x = torch.randn((2, 5, 3, 2 * half))
    pos = torch.randint(0, 50, (2, 5, 3))
    inv = layers.rope_freqs(2 * half, 1e6)
    sel = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    want = layers._rotate(x, pos[..., sel].float() * inv)
    assert torch.equal(layers.apply_mrope(x, pos, 1e6, sections), want)
    assert math.isfinite(float(want.abs().max()))
