"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Every source in ``repro_torch/csrc/`` is compiled on its own for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface under ``build/kernels/`` at the repository root. A build
is keyed by a hash of its source and flags, so an edited kernel rebuilds and
an unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all
at once; :func:`library` builds (if needed) and loads one of them at first
use. Nothing here runs at import time: the CPU never touches a kernel.

Each library exports ``kernel_error_string(int)`` and launch functions that
take device pointers, sizes, the device index and the CUDA stream as plain
integers, launch on that stream, allocate nothing, and return the
``cudaGetLastError()`` code of the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ellmean", "hindex", "topk")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels are built from source at first use"
        )
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together. Returns ``{name: compiler output}``
    for the sources compiled. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- {name}.cu ---\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require(t, name: str, dtypes, ndim: int, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    with ``ndim`` dimensions (on ``device`` when given): a wrapper hands the
    kernel raw pointers, so anything else is refused before the launch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device) -> int:
    """The current CUDA stream of ``device`` as a plain integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
