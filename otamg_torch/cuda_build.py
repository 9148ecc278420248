"""Build and load the port's CUDA kernels.

Every ``otamg_torch/csrc/*.cu`` file is compiled by ``nvcc`` into its own
shared library with a plain C interface under ``otamg_torch/_build/``
(listed in ``.gitignore``), and loaded with ``ctypes``.  Nothing is built
at import: the first call of :func:`load` builds all sources at once, one
``nvcc`` process per source, started together, and a library newer than
its source is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def stale() -> list[Path]:
    """The sources whose library is missing or older than the source."""
    out = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = BUILD / f"lib{src.stem}.so"
        if not (lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime):
            out.append(src)
    return out


def build_all(verbose: bool = False) -> float:
    """Compile every stale source in parallel; returns the seconds spent.
    Raises with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    BUILD.mkdir(exist_ok=True)
    procs = []
    for src in stale():
        out = BUILD / f"lib{src.stem}.so"
        tmp = BUILD / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        if verbose and log:
            print(log, file=sys.stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
    return lib
