"""The port stands alone: no module of ``adas_tpu_torch`` (and not
``chip_smoke.py``) imports ``jax`` or anything of the JAX package
``adas_tpu``, and its facades run on the card unless the caller names the
CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "adas_tpu_torch")
BLOCKED = ("adas_tpu", "jax", "jaxlib", "flax")


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def imported_roots(path: str):
    """Top-level package of every import statement in ``path``, with its
    line, including imports inside functions."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", port_sources())
def test_source_imports_nothing_of_jax(path):
    bad = [(root, line) for root, line in imported_roots(path) if root in BLOCKED]
    assert not bad, f"{path} imports {bad}"


IMPORT_ALL = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    import adas_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(adas_tpu_torch.__path__, "adas_tpu_torch."))
    for name in names:
        importlib.import_module(name)
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print(len(names))
    """
    % (BLOCKED, BLOCKED)
)


def test_every_module_imports_with_jax_package_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40  # every module was walked


def _facades():
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import YoloDetector

    return {"yolo": YoloDetector, "lane": UltrafastLaneDetectorV2, "effdet": EfficientdetDetector}


@pytest.mark.parametrize("name", ["yolo", "lane", "effdet"])
def test_facade_defaults_to_the_card(name):
    """With no device named, a facade builds on ``cuda``; without a card it
    raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _facades()[name]()


@pytest.mark.parametrize("name", ["yolo_preprocess", "ufld_v2_preprocess", "imagenet_preprocess"])
def test_preprocess_defaults_to_the_card(name):
    """The public preprocess helpers, like the facades, put their output on
    ``cuda`` unless the caller names the CPU."""
    import inspect

    from adas_tpu_torch.ops import preprocess

    assert inspect.signature(getattr(preprocess, name)).parameters["device"].default == "cuda"
