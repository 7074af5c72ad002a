"""Lazy in-tree build of the port's CUDA kernels.

Compiles ``csrc/<name>.cu`` with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>.so`` (a shared library with a plain C interface) the
first time a kernel is launched, or when the source is newer than the
binary, then loads it with ctypes; :func:`build_cuda_libraries` builds
several at once (one ``nvcc`` per source, started together).  Same scheme as
``adas_tpu/native/build.py``; nothing is built when a module is imported,
so the CPU tests import every module on a machine with no ``nvcc``.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)
or ``PATH``.  A missing compiler or a failed build raises: there is no
fallback.  The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as
``lib<name>.ptxas.txt``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LOCK = threading.Lock()
_CACHE: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and PATH): the port's CUDA "
            "kernels are built from source on the machine with the GPU"
        )
    return found


def _paths(name: str):
    src = os.path.join(SRC_DIR, f"{name}.cu")
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    return src, os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, out = _paths(name)
    return not os.path.isfile(out) or os.path.getmtime(out) < os.path.getmtime(src)


def build_cuda_libraries(names) -> None:
    """Build every stale ``csrc/<name>.cu`` of ``names``, one ``nvcc`` per
    source, all started together; raises if any build fails."""
    with _LOCK:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in todo:
            src, out = _paths(name)
            tmp = out + f".{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, src, "-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            procs.append((name, src, out, tmp, proc))
        failed = []
        for name, src, out, tmp, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {src} (exit {proc.returncode}):\n{log}")
                continue
            with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt"), "w") as f:
                f.write(log)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (if stale) and load ``_build/lib<name>.so`` from
    ``csrc/<name>.cu``."""
    if name in _CACHE:
        return _CACHE[name]
    build_cuda_libraries([name])
    with _LOCK:
        if name not in _CACHE:
            _CACHE[name] = ctypes.CDLL(_paths(name)[1])
        return _CACHE[name]
