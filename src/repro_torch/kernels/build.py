"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into
``<repo>/build/repro_torch/libkernels-<hash>.so``, where the hash covers the
sources and the flags, so a changed source never loads a stale library.
The library has a plain C interface and is loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps the build to seconds. It links
only the CUDA runtime; the flash kernel reaches the driver's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``.

Nothing here runs at import time: the CPU tests import every module on a
machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import namedtuple
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the loaded library, its path, and what ptxas said while building it
KernelLibrary = namedtuple("KernelLibrary", ["lib", "path", "ptxas_log"])
_loaded: KernelLibrary | None = None


class KernelBuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (unless this exact build exists) and load the kernels."""
    global _loaded
    if _loaded is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libkernels-{source_hash()}.so"
        log_path = target.with_suffix(".log")
        if not target.exists():
            # written aside and renamed: a concurrent loader never sees a
            # half-written library
            tmp = target.with_name(f".{target.name}.{os.getpid()}")
            nvcc = find_nvcc()
            srcs = sorted(CSRC.glob("*.cu"))
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
            cmds = [[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
                     str(obj)] for src, obj in zip(srcs, objs)]
            cmds.append([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                         str(tmp)])
            log = ""
            for batch in (cmds[:-1], cmds[-1:]):  # the sources, then the link
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for c in batch]
                outs = [proc.communicate()[0] for proc in procs]
                log += "".join(outs)
                for cmd, proc, out in zip(batch, procs, outs):
                    if proc.returncode != 0:
                        raise KernelBuildError(
                            f"nvcc failed:\n$ {' '.join(cmd)}\n{out}")
            for obj in objs:
                obj.unlink()
            log_path.write_text(log)
            os.replace(tmp, target)
        ptxas = log_path.read_text() if log_path.exists() else ""
        _loaded = KernelLibrary(ctypes.CDLL(str(target)), target, ptxas)
    return _loaded
