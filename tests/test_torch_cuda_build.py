"""The lazy CUDA build (``adas_tpu_torch/ops/cuda_build.py``) notices what
its libraries are built from: a source's own ``.cu`` and every shared
header in ``csrc/`` (``int8_epilogue.cuh`` is included by both
``int8_conv.cu`` and ``block.cu``).  Staleness reads only mtimes, so these
tests need no ``nvcc``: they work on a temporary copy of ``csrc/`` with
placeholder libraries."""
from __future__ import annotations

import os
import shutil

import pytest

from adas_tpu_torch.ops import cuda_build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.SRC_DIR, src)
    build = tmp_path / "_build"
    build.mkdir()
    monkeypatch.setattr(cuda_build, "SRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    t0 = max(os.path.getmtime(p) for p in src.iterdir())
    for p in src.iterdir():  # every source and header at one time, before the builds
        os.utime(p, (t0, t0))
    for name in ("block", "int8_conv", "stem"):
        lib = build / f"lib{name}.so"
        lib.write_bytes(b"")
        os.utime(lib, (t0 + 10, t0 + 10))
    return src, t0


def test_shared_header_is_in_csrc():
    names = os.listdir(cuda_build.SRC_DIR)
    assert "int8_epilogue.cuh" in names
    for user in ("int8_conv.cu", "block.cu"):
        with open(os.path.join(cuda_build.SRC_DIR, user)) as f:
            assert '#include "int8_epilogue.cuh"' in f.read()


@pytest.mark.parametrize("name", ["block", "int8_conv", "stem"])
def test_fresh_library_is_not_stale(tree, name):
    assert not cuda_build._stale(name)


@pytest.mark.parametrize("name", ["block", "int8_conv", "stem"])
def test_touched_header_marks_every_library_stale(tree, name):
    src, t0 = tree
    os.utime(src / "int8_epilogue.cuh", (t0 + 20, t0 + 20))
    assert cuda_build._stale(name)


def test_touched_source_marks_only_its_library_stale(tree):
    src, t0 = tree
    os.utime(src / "block.cu", (t0 + 20, t0 + 20))
    assert cuda_build._stale("block")
    assert not cuda_build._stale("int8_conv")


def test_missing_library_is_stale(tree):
    assert not os.path.exists(os.path.join(cuda_build.BUILD_DIR, "libnms.so"))
    assert cuda_build._stale("nms")
