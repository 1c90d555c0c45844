"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` (``SOURCES``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, on
first use, and loaded with ``ctypes``.  The libraries land in ``build/``
beside this file (listed in ``.gitignore``), each named by a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  ``build_all()``
starts one ``nvcc`` per source at once and waits for all of them.  Nothing here runs at import: the CPU-only test hosts
import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# source name -> the module whose ``bind(lib)`` declares its C signatures
SOURCES = {
    "plan_scan": "repro_torch.kernels.plan_scan",
    "flash_attention": "repro_torch.kernels.flash_attention",
    "mamba_scan": "repro_torch.kernels.mamba_scan",
    "hash_join": "repro_torch.kernels.hash_join",
    "merge_join": "repro_torch.kernels.merge_join",
}

# -fmad=false and IEEE division and expf (nvcc's defaults without
# --use_fast_math): every float32 operation rounds as written, so the
# plan-scan kernels equal their plain torch versions bit for bit and the
# model kernels differ from theirs only in summation order
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}     # set by the calls that compiled


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} on a host with the CUDA toolkit")


def source_path(name: str) -> Path:
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; known: "
                       f"{sorted(SOURCES)}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(source_path(name).read_bytes() + headers +
                     " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` each, all started together; returns name -> library path.
    Raises with nvcc's output when any build fails."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, todo[name])
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first
    call), with its C signatures declared."""
    if name not in _libs:
        path = build_all([name])[name]
        module = importlib.import_module(SOURCES[name])
        _libs[name] = module.bind(ctypes.CDLL(str(path)))
    return _libs[name]


# ------------------------------ launch helpers ------------------------------ #

def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors on one device (launch kernel ``name``), False
    for CPU tensors (take its plain version); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors on unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the C functions take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise on the ``cudaGetLastError()`` a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
