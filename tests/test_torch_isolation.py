"""The port stands alone: no module of ``adas_tpu_torch`` (and not
``chip_smoke.py``) imports ``jax``, anything of the JAX package
``adas_tpu`` or ``cv2`` (the GPU host has none), its single-frame path runs
in a process where none of them can be imported, and its facades and
pipeline run on the card unless the caller names the CPU."""
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
BLOCKED = ("adas_tpu", "jax", "jaxlib", "flax", "cv2")


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
    assert int(proc.stdout.split()[-1]) >= 50  # every module was walked


FRAME_SCRIPT = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    import numpy as np
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.pipeline.app import ADASPipeline
    from adas_tpu_torch.pipeline.fused import FusedADASStep
    from adas_tpu_torch.utils.types import LaneModelType

    ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = ufld.UFLDv2Spec(
        64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64)
    frames = np.random.default_rng(0).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
    n = 0
    for use_fused in (True, False):
        pipe = ADASPipeline(frame_size=(320, 180), use_fused=use_fused, device="cpu",
                            object_config={"input_size": (96, 96), "box_score": 0.25})
        for f in frames:
            pipe.process_frame(f, draw=False)
            n += len(pipe.objectDetector.object_info)
    FusedADASStep(pipe.objectDetector, pipe.laneDetector, transport="i420").run(frames[0])
    bird = pipe.transformView.transformToBirdView(frames[0])
    assert bird.shape == frames[0].shape and bird.flags.writeable
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("frames", n)
    """
    % (BLOCKED, BLOCKED)
)


def test_single_frame_path_runs_with_jax_package_and_cv2_blocked():
    """``ADASPipeline.process_frame`` on both routes, the i420 fused step
    and the bird-view warp, in a process that cannot import ``jax``,
    ``adas_tpu`` or ``cv2``."""
    proc = subprocess.run(
        [sys.executable, "-c", FRAME_SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("frames")


def _facades():
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.pipeline.app import ADASPipeline

    return {"yolo": YoloDetector, "lane": UltrafastLaneDetectorV2, "effdet": EfficientdetDetector,
            "pipeline": ADASPipeline}


@pytest.mark.parametrize("name", ["yolo", "lane", "effdet", "pipeline"])
def test_facade_defaults_to_the_card(name):
    """With no device named, a facade (and the per-frame pipeline) builds
    on ``cuda``; without a card it raises rather than carry on on the
    CPU."""
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
