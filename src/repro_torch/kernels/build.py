"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into
``libkernels-<hash>.so`` in ``<repo>/build/repro_torch/`` or in the
directory the caller names, where the hash covers the sources and the
flags, so a changed source never loads a stale library. The launchers
build into the job's environment (``JobSpec.env_setup``), so BootSeer's
env cache snapshots the library and a warm restart restores it instead of
running ``nvcc``. The library has a plain C interface and is loaded with
``ctypes``: no PyTorch headers are compiled, which keeps the build to
seconds. It links only the CUDA runtime; the flash kernel reaches the
CUDA driver's ``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``.

Nothing here runs at import time: the CPU tests import every module on a
machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import namedtuple
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the loaded library, its path, and what ptxas said while building it
KernelLibrary = namedtuple("KernelLibrary", ["lib", "path", "ptxas_log"])
_loaded: KernelLibrary | None = None
# every nvcc build this process ran: (library path, seconds)
builds: list[tuple[Path, float]] = []


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


def compile_into(directory: str | Path) -> Path:
    """The path of this source's library in ``directory``, compiled there
    first unless it exists (its ptxas report beside it, ``.log``)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    target = directory / f"libkernels-{source_hash()}.so"
    if target.exists():
        return target
    t0 = time.perf_counter()
    # written aside and renamed: a concurrent loader never sees a
    # half-written library
    tmp = target.with_name(
        f".{target.name}.{os.getpid()}.{threading.get_ident()}")
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
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)
    builds.append((target, time.perf_counter() - t0))
    return target


def build(directory: str | Path | None = None) -> KernelLibrary:
    """Load the kernels, compiling them into ``directory`` (by default
    ``BUILD_DIR``) unless this exact build exists there. The first load
    wins for the process: without ``directory`` a loaded library is
    returned as it is, and with one the library is still compiled there
    if absent, then the loaded one returned."""
    global _loaded
    if _loaded is not None and directory is None:
        return _loaded
    target = compile_into(BUILD_DIR if directory is None else directory)
    if _loaded is None:
        log_path = target.with_suffix(".log")
        ptxas = log_path.read_text() if log_path.exists() else ""
        _loaded = KernelLibrary(ctypes.CDLL(str(target)), target, ptxas)
    return _loaded
