"""g++ build of the port's C++ sources into ``adas_tpu_torch/_build/``:
a library is rebuilt when its source is newer than the binary, and a
failed build raises (there is no fallback)."""
from __future__ import annotations

import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def build_library(src: str, name: str, deps=()) -> str:
    """Compile ``src`` into ``_build/lib<name>.so`` if it is older than
    ``src`` or any of ``deps`` (the sources it includes); returns the
    library's path."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    newest = max(os.path.getmtime(f) for f in (src, *deps))
    if not os.path.isfile(out) or os.path.getmtime(out) < newest:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = out + f".{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out
