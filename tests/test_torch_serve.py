"""The port's serving path against the JAX package's ``ServeEngine`` on
tiny fp32 qwen2.5-3b and mamba2-370m, the serving CLI on the CPU, and the
port's independence from JAX and from the reference package.

Greedy tokens must be identical: fp32 logits agree to ~1e-6 (see
test_torch_model.py), far inside any gap between the top two logits of
these prompts. Temperature sampling uses different generators in the two
packages and is checked for determinism only.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import make_rules
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.step import make_decode_step

ARCH = "qwen2.5-3b"
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _engines(arch: str):
    """(JAX engine, port engine) over the same fp32 weights, batch 3."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jcfg = jreduced(jget_config(arch), dtype="float32")
    jm = JModel(jcfg, make_rules(mesh))
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config(arch), dtype="float32")
    m = Model(cfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (JServeEngine(jm, jp, batch=3, cache_len=24),
            ServeEngine(m, tp, batch=3, cache_len=24, device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return _engines(ARCH)


@pytest.fixture(scope="module")
def mamba_engines():
    return _engines("mamba2-370m")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("lens,new", [((5, 11, 8), 6),   # mixed lengths
                                      ((9, 3), 18)])     # padded batch, ring wraps
def test_greedy_tokens_match_reference(engines, lens, new):
    jeng, teng = engines
    prompts = _prompts(teng.model.cfg.vocab_size, lens, seed=len(lens))
    jout = jeng.generate([JRequest(prompt=p, max_new_tokens=new)
                          for p in prompts])
    tout = teng.generate([Request(prompt=p, max_new_tokens=new)
                          for p in prompts])
    assert [r.generated for r in tout] == [r.generated for r in jout]
    assert all(len(r.generated) == new for r in tout[:len(lens)])


@pytest.mark.parametrize("lens,new", [((5, 11, 8), 6),   # mixed lengths
                                      ((40, 3), 12)])    # padded batch, 2 chunks
def test_mamba_greedy_tokens_match_reference(mamba_engines, lens, new):
    jeng, teng = mamba_engines
    prompts = _prompts(teng.model.cfg.vocab_size, lens, seed=len(lens) + 7)
    jout = jeng.generate([JRequest(prompt=p, max_new_tokens=new)
                          for p in prompts])
    tout = teng.generate([Request(prompt=p, max_new_tokens=new)
                          for p in prompts])
    assert [r.generated for r in tout] == [r.generated for r in jout]
    assert all(len(r.generated) == new for r in tout[:len(lens)])


def test_mamba_decode_step_checks_the_cache(mamba_engines):
    _, teng = mamba_engines
    step = make_decode_step(teng.model, 3, 24)
    with pytest.raises(ValueError, match="batch 3"):
        step(teng.params, torch.zeros((3, 1), dtype=torch.long),
             teng.model.init_cache(2, 24), 0)


def test_engine_keeps_the_reference_quirks(engines):
    _, teng = engines
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in zip(_prompts(teng.model.cfg.vocab_size, (4, 6)), (3, 5))]
    out = teng.generate(reqs)
    assert out is reqs and len(reqs) == 3  # padded in place to the batch
    assert reqs[2].max_new_tokens == 0 and reqs[2].generated == []
    # the token sampled from the prefill logits feeds the first decode step
    # but is not part of ``generated``
    assert [len(r.generated) for r in reqs] == [3, 5, 0]


def test_temperature_sampling_is_seeded(engines):
    _, teng = engines

    def run(seed):
        reqs = [Request(prompt=p, max_new_tokens=6, temperature=t)
                for p, t in zip(_prompts(teng.model.cfg.vocab_size, (4, 7, 5)),
                                (0.0, 0.7, 1.3))]
        return [r.generated for r in teng.generate(reqs, seed=seed)]

    first = run(1)
    assert first == run(1)
    assert all(0 <= t < teng.model.cfg.vocab_size for g in first for t in g)


def test_engine_rejects_an_oversized_batch(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="batch"):
        teng.generate([Request(prompt=np.ones(2, np.int32))] * 4)


def test_engine_defaults_to_the_card(engines):
    _, teng = engines
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(teng.model, teng.params, batch=3, cache_len=24)


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2.5-3b",
                                  "zamba2-1.2b"])
def test_serve_cli_on_cpu(capsys, arch):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                    "--new-tokens", "4", "--batch", "2", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on CPU" in out
    assert f"{arch}-tiny" in out


def test_serve_cli_defaults_to_mamba2(capsys):
    serve_cli.main(["--device", "cpu", "--requests", "1", "--new-tokens", "2",
                    "--batch", "1"])
    assert "mamba2-370m-tiny" in capsys.readouterr().out


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_and_no_reference(path):
    assert not {n for n in _imported_modules(path) if _foreign(n)}


def test_importing_the_port_loads_no_jax_and_no_reference():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (f"import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]", out.stdout
