"""Build and load the port's hand-written CUDA kernels.

``load_library()`` compiles ``csrc/plan_scan.cu`` with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, on first use,
and loads it with ``ctypes``.  The library lands in ``build/`` beside this
file (listed in ``.gitignore``), named by a hash of the source and flags,
so an edited source rebuilds and an unchanged one is reused.  Nothing here
runs at import: the CPU-only test hosts import every module and have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCE = CSRC / "plan_scan.cu"

# -fmad=false and IEEE division (nvcc's default, no --use_fast_math): the
# kernels' float32 arithmetic rounds op for op like the plain torch version
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None      # set by the call that compiled


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{SOURCE} on a host with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"plan_scan-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists; returns
    its path.  Raises with nvcc's output when the build fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.plan_scan import bind
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib
