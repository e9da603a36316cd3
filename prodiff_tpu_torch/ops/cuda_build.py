"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source file has a plain C interface (no PyTorch headers), so a build
takes seconds. The shared library goes into ``build/cuda/`` at the checkout
root (listed in ``.gitignore``; override with ``PRODIFF_TORCH_BUILD_DIR``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags so an edited kernel is rebuilt. A library may be built as a variant
with preprocessor defines (``("ublock", ("LVCT_SKIP=1",))``): a library of
its own, which only measurement code asks for. Nothing is built or loaded at import time: the
first wrapper call on a CUDA tensor does it, or :func:`load_all`, which runs
one nvcc per source at once. A missing compiler or a failed build raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple, Union

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], Tuple[ctypes.CDLL, str]] = {}
Spec = Union[str, Tuple[str, Sequence[str]]]  # a source's name, or (name, defines)


def _key(spec: Spec) -> Tuple[str, Tuple[str, ...]]:
    return (spec, ()) if isinstance(spec, str) else (spec[0], tuple(spec[1]))


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


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _paths(name: str, defines: Tuple[str, ...]) -> Tuple[str, str]:
    """(source, library path named by the hash of the source, the shared
    headers and the flags)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


def load_all(names: Sequence[Spec]) -> None:
    """Build every missing library of ``names`` with one nvcc each, all
    started together, then load them."""
    with _lock:
        todo = list(dict.fromkeys(k for k in map(_key, names) if k not in _loaded))
        procs = []
        try:
            for name, defines in todo:
                src, lib_path = _paths(name, defines)
                if os.path.exists(lib_path):
                    continue
                os.makedirs(os.path.dirname(lib_path), exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                procs.append((src, lib_path, tmp, subprocess.Popen(
                    [_nvcc(), *_flags(defines), "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )))
            failed = []
            for src, lib_path, tmp, proc in procs:
                out, err = proc.communicate()
                with open(lib_path[: -len(".so")] + ".log", "w") as f:
                    f.write(out + err)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {src} (rc {proc.returncode}):\n{err[-4000:]}")
                else:
                    os.replace(tmp, lib_path)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        for key in todo:
            _, lib_path = _paths(*key)
            _loaded[key] = (ctypes.CDLL(lib_path), lib_path[: -len(".so")] + ".log")


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/{name}.cu``."""
    load_all([(name, defines)])
    with _lock:
        return _loaded[_key((name, defines))][0]


def build_log(name: str, defines: Sequence[str] = ()) -> str:
    """The compiler's output (ptxas register/spill report) of a loaded library."""
    with _lock:
        path = _loaded[_key((name, defines))][1]
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
