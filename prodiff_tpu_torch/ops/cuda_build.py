"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source file has a plain C interface (no PyTorch headers), so a build
takes seconds. The shared library goes into ``build/cuda/`` at the checkout
root (listed in ``.gitignore``; override with ``PRODIFF_TORCH_BUILD_DIR``),
named by a hash of the source so an edited kernel is rebuilt. Nothing is
built or loaded at import time: the first wrapper call on a CUDA tensor does
it. A missing compiler or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def build_dir() -> str:
    return os.environ.get(
        "PRODIFF_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda"),
    )


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def load(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/{name}.cu``."""
    with _lock:
        if name in _loaded:
            return _loaded[name][0]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir, f"lib{name}_{digest}.so")
        log_path = lib_path[: -len(".so")] + ".log"
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (rc {proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        _loaded[name] = (lib, log_path)
        return lib


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/spill report) of a loaded library."""
    with _lock:
        path = _loaded[name][1]
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class LaunchCounter:
    """Count of kernel launches made by one wrapper; thread-safe."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n
