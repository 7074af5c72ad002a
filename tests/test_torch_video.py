"""The port's video I/O (``render/video.py``, YUV4MPEG2) and its demo entry
points (``pipeline/app.run_video``, ``run_synthetic``, ``main``) on the
CPU.

The Y4M writer's planes equal ``cv2.cvtColor(COLOR_BGR2YUV_I420)`` and
the reader's BGR ``cv2.cvtColor(COLOR_YUV2BGR_I420)``; a write-read round
trip is exact on the I420 planes.  ``run_synthetic`` and ``run_video``
write the frames a ``process_frame(draw=True)`` loop over the same
decoded frames draws, on small nets (YOLOv8n at 96x96, a reduced
UFLDv2-CULane) so that the test stays short.
"""
from __future__ import annotations

import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.models import ufld  # noqa: E402
from adas_tpu_torch.ops.preprocess import bgr_to_i420  # noqa: E402
from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector  # noqa: E402
from adas_tpu_torch.pipeline import app  # noqa: E402
from adas_tpu_torch.render.video import Y4MReader, Y4MWriter  # noqa: E402
from adas_tpu_torch.tracking.base_track import BaseTrack  # noqa: E402
from adas_tpu_torch.utils.types import LaneModelType  # noqa: E402


def _frames(n, hw=(96, 160), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def test_writer_planes_equal_cv2(tmp_path):
    fs = _frames(3, (720, 1280))
    path = str(tmp_path / "v.y4m")
    with Y4MWriter(path, 1280, 720, fps=25) as w:
        for f in fs:
            w.write(f)
    with Y4MReader(path) as r:
        assert (r.width, r.height, r.fps) == (1280, 720, 25.0)
        for f in fs:
            np.testing.assert_array_equal(r.read_i420(), cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420))
        assert r.read_i420() is None


def test_reader_bgr_equals_cv2_and_round_trip_is_exact(tmp_path):
    """Arbitrary I420 planes (not only those of an encoded frame) decode as
    cv2 decodes them; writing the planes back and reading them again
    gives the same planes."""
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 256, (720 * 3 // 2, 1280), dtype=np.uint8) for _ in range(2)]
    path = str(tmp_path / "v.y4m")
    with Y4MWriter(path, 1280, 720) as w:
        for p in planes:
            w.write_i420(p)
    with Y4MReader(path) as r:
        for p in planes:
            got = r.read_i420()
            np.testing.assert_array_equal(got, p)
    with Y4MReader(path) as r:
        decoded = list(r)
    assert len(decoded) == 2
    for p, f in zip(planes, decoded):
        np.testing.assert_array_equal(f, cv2.cvtColor(p, cv2.COLOR_YUV2BGR_I420))


@pytest.mark.parametrize("chroma", ["", " C420", " C420jpeg", " C420mpeg2", " C420paldv"])
def test_reader_takes_the_420_tags(tmp_path, chroma):
    path = tmp_path / "v.y4m"
    plane = np.random.default_rng(2).integers(0, 256, (6, 4), dtype=np.uint8)
    path.write_bytes(b"YUV4MPEG2 W4 H4 F30000:1001 Ip A1:1" + chroma.encode() + b" XCOMMENT\n"
                     + b"FRAME\n" + plane.tobytes())
    with Y4MReader(str(path)) as r:
        assert abs(r.fps - 29.97) < 1e-3
        np.testing.assert_array_equal(r.read_i420(), plane)
        assert r.read() is None


def test_reader_and_writer_raise(tmp_path):
    with pytest.raises(ValueError, match="ffmpeg"):
        Y4MReader(str(tmp_path / "clip.mp4"))
    with pytest.raises(ValueError, match="ffmpeg"):
        Y4MWriter(str(tmp_path / "clip.mp4"), 64, 64)
    bad = tmp_path / "v.y4m"
    bad.write_bytes(b"YUV4MPEG2 W4 H4 F30:1 C444\nFRAME\n" + bytes(48))
    with pytest.raises(ValueError, match="C444"):
        Y4MReader(str(bad))
    bad.write_bytes(b"YUV4MPEG2 W4 H4 F30:1\nFRAME\n" + bytes(10))
    with Y4MReader(str(bad)) as r, pytest.raises(ValueError, match="truncated"):
        r.read()
    with pytest.raises(ValueError, match="even"):
        Y4MWriter(str(tmp_path / "odd.y4m"), 63, 64)


@pytest.fixture
def small_nets(monkeypatch):
    """YOLOv8n at 96x96 and a reduced UFLDv2-CULane as the pipeline's
    defaults; a clock that never moves in the app and the panel (their
    printed times); ``random`` seeded alike before every pipeline."""
    monkeypatch.setitem(ufld.UFLDV2_SPECS, LaneModelType.UFLDV2_CULANE,
                        ufld.UFLDv2Spec(64, 160, 0.6, 20, 72, 10, 16, mlp_mid=64))
    monkeypatch.setattr(YoloDetector, "_defaults", {**YOLO_OPTIONS, "input_size": (96, 96),
                                                    "box_score": 0.25})

    class Clock:
        @staticmethod
        def time():
            return 1000.0

    import adas_tpu_torch.pipeline.panel as panel

    monkeypatch.setattr(app, "time", Clock)
    monkeypatch.setattr(panel, "time", Clock)

    real = app.ADASPipeline

    def seeded(frame_size, **kw):
        random.seed(3)
        BaseTrack.reset_counter()
        return real(frame_size=frame_size, **kw)

    monkeypatch.setattr(app, "ADASPipeline", seeded)
    return lambda hw: seeded(hw[::-1], device="cpu")


def _loop(pipeline, hw, frames):
    pipe = pipeline(hw)
    return [bgr_to_i420(pipe.process_frame(f)) for f in frames]


def test_run_synthetic_writes_the_drawn_frames(tmp_path, small_nets):
    hw = (96, 160)
    out = str(tmp_path / "synthetic_out.y4m")
    assert app.run_synthetic(out, frames=3, frame_hw=hw, device="cpu") == 3
    rng = np.random.default_rng(0)
    want = _loop(small_nets, hw, [rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
                                  for _ in range(3)])
    with Y4MReader(out) as r:
        got = [r.read_i420() for _ in range(3)]
        assert r.read_i420() is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_run_video_writes_the_drawn_frames(tmp_path, small_nets):
    hw = (96, 160)
    src, out = str(tmp_path / "in.y4m"), str(tmp_path / "in_out.y4m")
    with Y4MWriter(src, hw[1], hw[0], fps=12) as w:
        for f in _frames(4, hw, seed=4):
            w.write(f)
    assert app.run_video(src, out, device="cpu", max_frames=3) == 3
    with Y4MReader(src) as r:
        decoded = [r.read() for _ in range(3)]
    want = _loop(small_nets, hw, decoded)
    with Y4MReader(out) as r:
        assert r.fps == 12.0
        got = [r.read_i420() for _ in range(4)]
    assert got[3] is None
    got = got[:3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    main_out = tmp_path / "main.y4m"
    app.main(["-i", src, "-o", str(main_out), "--device", "cpu", "--max-frames", "2"])
    with Y4MReader(str(main_out)) as r:
        assert len(list(r)) == 2
