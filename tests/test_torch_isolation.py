"""The port stands alone: no module of ``adas_tpu_torch`` (and not
``chip_smoke.py``) imports ``jax``, anything of the JAX package
``adas_tpu``, ``cv2`` or ``PIL`` (the GPU host has neither), ``optax``,
``orbax`` or ``onnx``, its single-frame path (with the HUD), its demo
CLI, the image codec, the lane demo, the ONNX exporter and the trainer
run in a process where none of them can be imported, and its facades,
pipeline and new entry points run on the card unless the caller names
the CPU."""
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
BLOCKED = ("adas_tpu", "jax", "jaxlib", "flax", "cv2", "PIL", "optax", "orbax")
#: what the sources may not import either: the ``onnx`` package (the port
#: parses and writes ONNX itself).  Not blocked in the child processes:
#: torch probes for it (``importlib.util.find_spec``) when it first
#: dispatches a registered operator.
NOT_IMPORTED = (*BLOCKED, "onnx")
#: the child processes' environment: one torch thread, as the test
#: processes have (``test_torch_models.py``)
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


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
    bad = [(root, line) for root, line in imported_roots(path) if root in NOT_IMPORTED]
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
    % (BLOCKED, NOT_IMPORTED)
)


def test_every_module_imports_with_jax_package_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=ONE_THREAD, capture_output=True, text=True, timeout=120,
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
            drawn = pipe.process_frame(f)
            assert drawn.shape == f.shape and not np.array_equal(drawn, f)
            n += len(pipe.objectDetector.object_info)
    FusedADASStep(pipe.objectDetector, pipe.laneDetector, transport="i420").run(frames[0])
    bird = pipe.transformView.transformToBirdView(frames[0])
    assert bird.shape == frames[0].shape and bird.flags.writeable
    from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector
    from adas_tpu_torch.pipeline.app import run_synthetic
    from adas_tpu_torch.render.video import Y4MReader

    YoloDetector.set_defaults({**YOLO_OPTIONS, "input_size": (96, 96)})
    out = sys.argv[1]
    assert run_synthetic(out, frames=2, frame_hw=(180, 320), device="cpu") == 2
    with Y4MReader(out) as r:
        assert len(list(r)) == 2
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("frames", n)
    """
    % (BLOCKED, BLOCKED)
)


def test_single_frame_path_runs_with_jax_package_and_cv2_blocked(tmp_path):
    """``ADASPipeline.process_frame`` on both routes, with and without the
    HUD, the i420 fused step, the bird-view warp and ``run_synthetic`` to a
    ``.y4m``, in a process that cannot import ``jax``, ``adas_tpu`` or
    ``cv2``."""
    proc = subprocess.run(
        [sys.executable, "-c", FRAME_SCRIPT, str(tmp_path / "synthetic.y4m")], cwd=REPO,
        env=ONE_THREAD, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("frames")


CLI_SCRIPT = textwrap.dedent(
    """
    import runpy, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    sys.argv = ["app"] + sys.argv[1:]
    runpy.run_module("adas_tpu_torch.pipeline.app", run_name="__main__")
    """
    % (BLOCKED,)
)


def test_demo_cli_runs_with_jax_package_and_cv2_blocked(tmp_path):
    """``python -m adas_tpu_torch.pipeline.app --synthetic --frames 2
    --device cpu`` (the default nets, 720p) writes a readable ``.y4m`` in
    a process that cannot import ``jax``, ``adas_tpu`` or ``cv2``."""
    from adas_tpu_torch.render.video import Y4MReader

    out = str(tmp_path / "out.y4m")
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, "--synthetic", "--frames", "2", "--device", "cpu",
         "-o", out], cwd=REPO, env=ONE_THREAD, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"wrote 2 frames to {out}" in proc.stdout
    with Y4MReader(out) as r:
        frames = list(r)
    assert (r.width, r.height, len(frames)) == (1280, 720, 2)


def _facades():
    from functools import partial

    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import (UltrafastLaneDetector,
                                                         UltrafastLaneDetectorV2)
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.pipeline.app import ADASPipeline
    from adas_tpu_torch.utils.types import ObjectModelType as T

    return {"yolo": YoloDetector, "lane": UltrafastLaneDetectorV2, "effdet": EfficientdetDetector,
            "pipeline": ADASPipeline, "lane_v1": UltrafastLaneDetector,
            "yolo_v9": partial(YoloDetector, model_type=T.YOLOV9, compute_dtype="int8"),
            "yolo_v7": partial(YoloDetector, model_type=T.YOLOV7),
            "yolo_v6": partial(YoloDetector, model_type=T.YOLOV6),
            "yolo_v5lite": partial(YoloDetector, model_type=T.YOLOV5_LITE),
            "effdet_int8": partial(EfficientdetDetector, compute_dtype="int8")}


@pytest.mark.parametrize("name", ["yolo", "lane", "effdet", "pipeline", "lane_v1", "yolo_v9",
                                  "yolo_v7", "yolo_v6", "yolo_v5lite", "effdet_int8"])
def test_facade_defaults_to_the_card(name):
    """With no device named, a facade (and the per-frame pipeline) builds
    on ``cuda``; without a card it raises rather than carry on on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _facades()[name]()


@pytest.mark.parametrize("name", ["yolo_preprocess", "ufld_v2_preprocess", "imagenet_preprocess",
                                  "ufld_v1_preprocess"])
def test_preprocess_defaults_to_the_card(name):
    """The public preprocess helpers, like the facades, put their output on
    ``cuda`` unless the caller names the CPU."""
    import inspect

    from adas_tpu_torch.ops import preprocess

    assert inspect.signature(getattr(preprocess, name)).parameters["device"].default == "cuda"


def test_port_imports_torch_numpy_scipy_only():
    """Beyond the standard library and itself, the port imports torch,
    numpy and scipy (scipy's LAPACK in ``ops/warp.py``, the tracker's
    ``scipy.linalg``), nothing else."""
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "scipy", "adas_tpu_torch"}
    found = {root for path in port_sources() if path.startswith("adas_tpu_torch")
             for root, _ in imported_roots(path)}
    assert found - allowed == set(), found - allowed
    assert "scipy" in found


FAMILIES_SCRIPT = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    import numpy as np
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.utils.types import ObjectModelType as T

    frames = list(np.random.default_rng(0).integers(0, 256, (2, 90, 160, 3), dtype=np.uint8))
    dets = [YoloDetector(model_type=T.YOLOV6, scale="n", input_size=(64, 64),
                         compute_dtype="int8", device="cpu"),
            YoloDetector(model_type=T.YOLOV5_LITE, scale="s", input_size=(64, 64),
                         compute_dtype="int8", device="cpu"),
            EfficientdetDetector(compound=0, input_size=128, compute_dtype="int8", device="cpu")]
    for d in dets:
        d.calibrate_int8(frames)
        d.DetectFrame(frames[0])
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("families", len(dets))
    """
    % (BLOCKED, BLOCKED)
)


def test_new_families_run_with_jax_package_and_cv2_blocked():
    """YOLOv6n (RepVGG fused at load), YOLOv5-lite-s (the padded 58-wide
    convs' plain path) and EfficientDet-D0, calibrated in int8 and
    detecting, in a process that cannot import ``jax``, ``adas_tpu`` or
    ``cv2``."""
    proc = subprocess.run(
        [sys.executable, "-c", FAMILIES_SCRIPT], cwd=REPO, env=ONE_THREAD, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("families 3")


CONFIG_SCRIPT = textwrap.dedent(
    """
    import builtins, io, os, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    from adas_tpu_torch.utils.config import CONFIG_DIR, Config

    opened, real_open = [], builtins.open

    def spy(file, *args, **kwargs):
        opened.append(os.path.realpath(file))
        return real_open(file, *args, **kwargs)

    builtins.open = io.open = spy
    names = sorted(n for n in os.listdir(CONFIG_DIR) if n.endswith(".py"))
    cfgs = [Config.fromfile(os.path.join(CONFIG_DIR, n)) for n in names]
    builtins.open = io.open = real_open
    jax_package = os.path.realpath("adas_tpu") + os.sep
    assert opened and not [p for p in opened if p.startswith(jax_package)], opened
    assert all(p.startswith(os.path.realpath(CONFIG_DIR) + os.sep) for p in opened), opened
    assert sorted(c.backbone for c in cfgs if "backbone" in c) == ["18"] * 3 + ["34"] * 3
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("configs", len(cfgs))
    """
    % (BLOCKED, BLOCKED)
)


def test_configs_load_from_the_port_alone():
    """``adas_tpu_torch/utils/config.py`` reads each of the port's seven
    UFLDv2 configs (and the bases they name) from ``adas_tpu_torch/configs``
    only, in a process that cannot import ``jax``, ``adas_tpu`` or
    ``cv2``: no path under ``adas_tpu/`` is opened."""
    proc = subprocess.run(
        [sys.executable, "-c", CONFIG_SCRIPT], cwd=REPO, env=ONE_THREAD, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("configs 7")


IMPORTERS_SCRIPT = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    from adas_tpu_torch.engine import registry
    from adas_tpu_torch.tools import (efficientdet_import, onnx_import, onnx_writer, params_io,
                                      quantize, torch_import, yolo_import)

    assert len(registry.available()) == 13
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("importers", len(registry.available()))
    """
    % (BLOCKED, BLOCKED)
)


def test_importers_and_registry_import_with_jax_package_blocked():
    """The checkpoint importers, the ONNX reader and writer, the store
    tools and the model registry import in a process that cannot import
    ``jax``, ``adas_tpu`` or ``cv2``."""
    proc = subprocess.run(
        [sys.executable, "-c", IMPORTERS_SCRIPT], cwd=REPO, env=ONE_THREAD, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "importers 13"


NEW_MODULES_SCRIPT = textwrap.dedent(
    """
    import glob, os, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    import numpy as np
    import torch
    from adas_tpu_torch.engine.onnx_engine import OnnxGraphEngine
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.parallel import (make_ufld_train_state, make_ufld_train_step,
                                         restore_train_state, save_train_state)
    from adas_tpu_torch.pipeline import lane_demo, transport_parity
    from adas_tpu_torch.render import image
    from adas_tpu_torch.tools.onnx_export import export_module_to_onnx
    from adas_tpu_torch.utils.types import LaneModelType

    tmp = sys.argv[1]
    data = os.path.join("tests", "data", "images")
    n = 0
    for path in sorted(glob.glob(os.path.join(data, "*.npy"))):
        src = [p for p in glob.glob(path[:-4] + ".*") if not p.endswith(".npy")][0]
        assert np.array_equal(image.imread(src), np.load(path)), src
        n += 1
    spec = ufld.UFLDv2Spec(64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64)
    ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = spec
    out = lane_demo.run_lane_image(os.path.join(data, "frame_720p.png"),
                                   os.path.join(tmp, "lanes.png"), device="cpu")
    assert out.shape == (720, 1280, 3) and image.imread(os.path.join(tmp, "lanes.png")).shape == out.shape
    view = transport_parity.transport_view(out, (360, 640))
    assert view.shape == (360, 640, 3)
    net, opt, state = make_ufld_train_state(spec, use_aux=True, device="cpu")
    step = make_ufld_train_step(net, opt)
    rng = np.random.default_rng(0)
    batch = {"images": torch.randn(2, 3, 64, 160),
             "row_targets": torch.from_numpy(rng.integers(0, 20, (2, 72, 4))),
             "col_targets": torch.from_numpy(rng.integers(0, 10, (2, 16, 4))),
             "row_exist": torch.from_numpy(rng.integers(0, 2, (2, 72, 4))),
             "col_exist": torch.from_numpy(rng.integers(0, 2, (2, 16, 4))),
             "seg_targets": torch.from_numpy(rng.integers(0, 5, (2, 8, 20)))}
    step(state, batch)
    restore_train_state(save_train_state(tmp, state, 1), state)
    net.eval()
    path = os.path.join(tmp, "lane.onnx")
    x = torch.randn(1, 3, 64, 160)
    export_module_to_onnx(net, x, path, ["images"])
    got = OnnxGraphEngine(path, device="cpu").engine_inference(x.numpy())
    with torch.no_grad():
        assert np.allclose(got[0], net(x)["loc_row"].numpy(), rtol=2e-4, atol=2e-4)
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("decoded", n)
    """
    % (BLOCKED, NOT_IMPORTED)
)


def test_new_modules_run_with_jax_package_cv2_and_pil_blocked(tmp_path):
    """The codec on every committed fixture, ``run_lane_image`` on a 720p
    PNG, ``transport_view``, a training step with the aux head and a
    checkpoint round trip, and an ONNX export served by the graph
    executor, in a process that cannot import ``jax``, ``adas_tpu``,
    ``cv2``, ``PIL``, ``optax``, ``orbax`` or ``onnx``."""
    proc = subprocess.run(
        [sys.executable, "-c", NEW_MODULES_SCRIPT, str(tmp_path)], cwd=REPO, env=ONE_THREAD,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 60


VIDEO_SCRIPT = textwrap.dedent(
    """
    import glob, hashlib, json, os, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    import numpy as np
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector
    from adas_tpu_torch.pipeline import app, lane_demo
    from adas_tpu_torch.render.video import MP4Reader, open_reader
    from adas_tpu_torch.utils.types import LaneModelType

    tmp = sys.argv[1]
    data = os.path.join("tests", "data", "video")
    with open(os.path.join(data, "sha256.json")) as f:
        digests = json.load(f)
    n = 0
    for name, want in digests.items():
        with MP4Reader(os.path.join(data, name)) as r:
            ys = [p[:r.height] for p in r.i420_frames()]
        assert [hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"], name
        n += len(ys)
    ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = ufld.UFLDv2Spec(
        64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64)
    YoloDetector.set_defaults({**YOLO_OPTIONS, "input_size": (96, 96)})
    out = os.path.join(tmp, "synthetic.mp4")
    assert app.run_synthetic(out, frames=2, frame_hw=(96, 160), device="cpu") == 2
    assert app.run_video(out, os.path.join(tmp, "again.mp4"), device="cpu") == 2
    assert lane_demo.run_lane_video(out, os.path.join(tmp, "lanes.mp4"), device="cpu") == 2
    for name in ("synthetic.mp4", "again.mp4", "lanes.mp4"):
        with open_reader(os.path.join(tmp, name)) as r:
            assert r.fps == 30.0 and len(list(r)) == 2
    # an H.264 input: an I_PCM IDR and two P pictures of a pan, in an avc1 MP4
    sys.path.insert(0, data)
    import h264_writer
    clip = os.path.join(tmp, "h264.mp4")
    frame = np.random.default_rng(5).integers(0, 256, (144, 160), dtype=np.uint8)
    h264_writer.to_mp4(h264_writer.content(frame, n_p=2, pan=(5, 3)), clip)
    assert app.run_video(clip, os.path.join(tmp, "h264_out.mp4"), device="cpu") == 3
    assert lane_demo.run_lane_video(clip, os.path.join(tmp, "h264_lanes.mp4"), device="cpu") == 3
    app.main(["-i", clip, "-o", os.path.join(tmp, "h264_cli.mp4"), "--device", "cpu"])
    lane_demo.main(["-i", clip, "-o", os.path.join(tmp, "h264_cli_lanes.mp4"), "--device", "cpu"])
    for name in ("h264_out.mp4", "h264_lanes.mp4", "h264_cli.mp4", "h264_cli_lanes.mp4"):
        with open_reader(os.path.join(tmp, name)) as r:
            assert (r.width, r.height) == (160, 96) and len(list(r)) == 3
    # with B pictures (IDR, then B P B P: a B pyramid of one reference B
    # per group): an avc1 MP4 with ctts and elst, and Annex B
    b_stream = h264_writer.content(frame, n_p=4, pan=(5, 3), bframes=1)
    b_mp4, b_raw = os.path.join(tmp, "b.mp4"), os.path.join(tmp, "b.h264")
    h264_writer.to_mp4(b_stream, b_mp4)
    with open(b_raw, "wb") as f:
        f.write(b_stream)
    for clip in (b_mp4, b_raw):
        stem = os.path.splitext(clip)[0]
        assert app.run_video(clip, stem + "_out.y4m", device="cpu") == 5
        assert lane_demo.run_lane_video(clip, stem + "_lanes.y4m", device="cpu") == 5
        app.main(["-i", clip, "-o", stem + "_cli.y4m", "--device", "cpu"])
        lane_demo.main(["-i", clip, "-o", stem + "_cli_lanes.y4m", "--device", "cpu"])
        for suffix in ("_out.y4m", "_lanes.y4m", "_cli.y4m", "_cli_lanes.y4m"):
            with open_reader(stem + suffix) as r:
                assert (r.width, r.height) == (160, 96) and len(list(r)) == 5
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("frames", n)
    """
    % (BLOCKED, NOT_IMPORTED)
)


def test_video_io_runs_with_jax_package_and_cv2_blocked(tmp_path):
    """The MP4 reader on every committed video fixture (cv2's Y planes by
    their sha256), ``run_synthetic``, ``run_video`` and ``run_lane_video``
    to ``.mp4``, and ``run_video``, ``run_lane_video`` and both CLIs over an
    H.264 ``.mp4`` of I/P pictures and over B-picture H.264 as an ``.mp4``
    (``ctts``, ``elst``) and as Annex B, in a process that cannot import
    ``jax``, ``adas_tpu``,
    ``cv2``, ``PIL``, ``optax``, ``orbax`` or ``onnx``."""
    proc = subprocess.run(
        [sys.executable, "-c", VIDEO_SCRIPT, str(tmp_path)], cwd=REPO, env=ONE_THREAD,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 80


AVI_SCRIPT = textwrap.dedent(
    """
    import hashlib, json, os, sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %r:
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.pipeline import app, lane_demo
    from adas_tpu_torch.render import avi, mjpeg
    from adas_tpu_torch.render.video import open_reader
    from adas_tpu_torch.utils.types import LaneModelType

    tmp = sys.argv[1]
    data = os.path.join("tests", "data", "video")
    sys.path.insert(0, data)
    import avi_clips
    with open(os.path.join(data, "avi", "sha256.json")) as f:
        digests = json.load(f)
    n = 0
    for name, want in digests.items():
        path = os.path.join(data, "avi", name)
        if name.startswith("clip_"):
            path = os.path.join(tmp, name)
            avi_clips.mjpeg_720p(path, damaged="damaged" in name)
        ys = []
        with open_reader(path) as r:
            while (p := r.read_planes()) is not None:
                ys.append(p[0] if isinstance(p, tuple) else p[:r.height])
        assert [hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"], name
        n += len(ys)
    ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = ufld.UFLDv2Spec(
        64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64)
    src = os.path.join(data, "avi", "cv2_mjpg_96x64.avi")
    out = os.path.join(tmp, "lanes.avi")
    assert lane_demo.run_lane_video(src, out, device="cpu", max_frames=2) == 2
    lane_demo.main(["-i", src, "-o", os.path.join(tmp, "cli_lanes.avi"), "--device", "cpu",
                    "--max-frames", "1"])
    for name, frames in (("lanes.avi", 2), ("cli_lanes.avi", 1)):
        with open_reader(os.path.join(tmp, name)) as r:
            assert r.fps == 30.0 and len(list(r)) == frames
    assert not [m for m in sys.modules if m.split(".")[0] in %r]
    print("frames", n)
    """
    % (BLOCKED, NOT_IMPORTED)
)


def test_avi_and_mjpeg_run_with_jax_package_and_cv2_blocked(tmp_path):
    """The AVI reader and writer and the Motion JPEG decoder
    (``render/{avi,mjpeg}.py``, ``native/mjpeg.cpp``): every AVI/MOV/MP4
    fixture of ``tests/data/video/avi`` and the 720p Motion JPEG clip, whole
    and damaged, decode to cv2's Y digests, and ``run_lane_video`` and the
    lane CLI read a Motion JPEG ``.avi`` and write an ``.avi``, in a process
    that cannot import ``jax``, ``adas_tpu``, ``cv2``, ``PIL``, ``optax``,
    ``orbax`` or ``onnx``."""
    proc = subprocess.run(
        [sys.executable, "-c", AVI_SCRIPT, str(tmp_path)], cwd=REPO, env=ONE_THREAD,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 16 * 5 + 24 + 23


@pytest.mark.parametrize("name", [
    "parallel.train:make_ufld_train_state", "pipeline.lane_demo:run_lane_image",
    "pipeline.lane_demo:run_lane_video", "tools.onnx_export:_build_export",
    "pipeline.app:run_video", "pipeline.app:run_synthetic",
    "tools.quantize:calibrate_store", "tools.quantize:calib_dir_frames",
])
def test_new_entry_points_default_to_the_card(name):
    """Each new entry point takes ``device`` with the default ``cuda``; the
    trainer raises without a card rather than train on the CPU."""
    import importlib
    import inspect

    module, fn = name.split(":")
    f = getattr(importlib.import_module(f"adas_tpu_torch.{module}"), fn)
    assert inspect.signature(f).parameters["device"].default == "cuda"
    if fn == "make_ufld_train_state" and not torch.cuda.is_available():
        from adas_tpu_torch.models.ufld import UFLDv2Spec

        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            f(UFLDv2Spec(64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64))
