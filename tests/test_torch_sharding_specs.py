"""The port's sharding rules against the JAX package's: every parameter
spec, activation and cache spec helper, for all ten archs on both
production meshes (16x16 and 2x16x16), under ``"tp"`` and ``"ep"`` and
the serving layout. The reference's ``Rules`` stand on an
``AbstractMesh``; the port's on a stand-in with a ``DeviceMesh``'s shape,
dim names and device type (a spec needs no process group)."""

from __future__ import annotations

import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_config
from repro.models.model import Model as JModel
from repro.sharding.rules import make_rules as jax_rules
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import Model
from repro_torch.sharding.rules import (Rules, make_rules,
                                        single_device_rules)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KNOBS = {"tp": {}, "ep": {"moe_sharding": "ep"},
         "serving": {"serving_layout": True},
         "seq_acts": {"seq_sharded_acts": True}}


def _norm(spec) -> tuple:
    """A spec as a tuple of None or name tuples, trailing Nones dropped."""
    out = [None if e is None else ((e,) if isinstance(e, str) else tuple(e))
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _pair(mesh_name: str, knob: str):
    shape, names = MESHES[mesh_name]
    ref = jax_rules(AbstractMesh(shape, names), **KNOBS[knob])
    return ref, make_rules(_ShapeMesh(shape, names), **KNOBS[knob])


class _ShapeMesh:
    device_type = "cpu"

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name, knob):
    ref, port = _pair(mesh_name, knob)
    want = {k: _norm(v) for k, v in
            _flat(ref.param_specs(jax_config(arch))).items()}
    got = {k: _norm(v) for k, v in
           _flat(port.param_specs(get_config(arch))).items()}
    assert got == want


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_activation_and_cache_helpers_equal_the_reference(mesh_name, knob):
    ref, port = _pair(mesh_name, knob)
    assert port.axis_sizes == dict(ref.axis_sizes)
    assert (port.data_axes, port.model_axis) == (ref.data_axes,
                                                 ref.model_axis)
    assert port.cache_axes == ref.cache_axes
    assert port.reduce_axes == ref.reduce_axes
    for rank in (0, 1, 17, 255):
        assert port.coords_of_rank(rank) == ref.coords_of_rank(rank)
    for n in (1, 2, 8, 56, 256, 512, 4096, 151936):
        assert _norm((port.dp(n),)) == _norm((ref.dp(n),))
        assert _norm((port.tp(n),)) == _norm((ref.tp(n),))
        for seq in (0, 1, 4096, 32768):
            assert _norm(port.act_btd(n, seq)) == _norm(ref.act_btd(n, seq))
        for vocab in (0, 32000, 151936, 152064):
            assert _norm(port.act_logits(n, vocab)) == \
                _norm(ref.act_logits(n, vocab))
        for name in ("act_ff", "seq_attn", "kv_cache", "ssm_state"):
            assert _norm(getattr(port, name)(n)) == \
                _norm(getattr(ref, name)(n)), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    """The port's flat cache dict holds the reference's entries (the
    hybrid's tuple's two dicts), each with its spec."""
    for knob in ("tp", "serving"):
        ref, port = _pair(mesh_name, knob)
        want = {}
        for k, v in _flat(JModel(jax_config(arch), ref).cache_specs(
                256, 32768)).items():
            want[k.split("/")[-1]] = _norm(v)
        model = Model(get_config(arch), port, device="cpu")
        specs = model.ops.cache_specs(256)
        got = {k: _norm(specs[k]) for k in
               model.cache_shapes(256, 32768)}
        assert got == want


def test_single_device_rules_are_the_one_by_one_mesh():
    """``single_device_rules()`` has no mesh (plain tensors) and gives
    every helper the reference's (1, 1) mesh gives."""
    ref = jax_rules(AbstractMesh((1, 1), ("data", "model")))
    port = single_device_rules()
    assert port.mesh is None and port.axis_sizes == dict(ref.axis_sizes)
    for arch in ARCHS:
        assert {k: _norm(v) for k, v in _flat(port.param_specs(
            get_config(arch))).items()} == {
            k: _norm(v) for k, v in _flat(ref.param_specs(
                jax_config(arch))).items()}
    assert _norm(port.act_btd(8, 1024)) == _norm(ref.act_btd(8, 1024))


def test_placements_and_unported_knobs():
    _, port = _pair("2x16x16", "tp")
    assert port.data_axes == ("pod", "data")
    assert port.placements((("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert port.placements((None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError):
        port.placements((("data", "pod"),))
    # the SSD knobs are taken as the reference takes them; bad values raise
    # as moe_sharding's and param_gather_dtype's do
    for kw in ({"ssd_compute_dtype": "bfloat16"}, {"ssm_chunk": 64},
               {"ssd_compute_dtype": "bfloat16", "ssm_chunk": 16}):
        r = Rules(mesh=None, **kw)
        assert all(getattr(r, k) == v for k, v in kw.items())
    for kw in ({"ssd_compute_dtype": "float16"}, {"ssm_chunk": -1}):
        with pytest.raises(ValueError):
            Rules(mesh=None, **kw)
