"""The port's video I/O (``render/video.py``: YUV4MPEG2, MP4 and AVI with
MPEG-4 Part 2, H.264 or Motion JPEG video, raw H.264) and its demo entry points
(``pipeline/app.run_video``, ``run_synthetic``, ``main``) on the CPU.

The Y4M writer's planes equal ``cv2.cvtColor(COLOR_BGR2YUV_I420)`` and
the reader's BGR ``cv2.cvtColor(COLOR_YUV2BGR_I420)``; a write-read round
trip is exact on the I420 planes.  ``run_synthetic`` and ``run_video``
write the frames a ``process_frame(draw=True)`` loop over the same
decoded frames draws, on small nets (YOLOv8n at 96x96, a reduced
UFLDv2-CULane) so that the test stays short: to the bit in a ``.y4m``; in
an ``.mp4``, every frame read back equals the writer's reconstruction of
the drawn frame (an encoder is deterministic, so a second writer given
the drawn frames reconstructs the same), within a Y PSNR bound of the
drawn frame, at 30 fps whatever the input's rate (the JAX package's
``cv2.VideoWriter(..., 30.0, ...)``), and the same in an ``.avi``, which
cv2 reads at 30 fps with every frame, from ``.avi`` input of ``mp4v`` or
Motion JPEG and from Motion JPEG in a ``.mov``; the CLI's default output
names are the JAX package's (``-i x.avi`` writes ``x_out.mp4``).
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
from adas_tpu_torch.render.video import (MP4Reader, MP4Writer, Y4MReader,  # noqa: E402
                                         Y4MWriter)
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
    with pytest.raises(ValueError, match=r"\.mp4.*\.y4m"):
        Y4MReader(str(tmp_path / "clip.mp4"))
    with pytest.raises(ValueError, match=r"\.mp4.*\.y4m"):
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


#: the least Y PSNR of an .mp4 frame against the drawn frame at the
#: encoder's fixed quantiser: the HUD over the synthetic noise frames
#: (measured 35.37-38.15 dB on these), and over smooth input frames
#: (39.62-41.32 dB)
NOISE_PSNR_DB, SMOOTH_PSNR_DB = 35.0, 38.0


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _reconstructed(drawn_i420, hw, path):
    """What an .mp4 writer reconstructs from the drawn frames."""
    with MP4Writer(path, hw[1], hw[0]) as vw:
        return [vw.write_i420(p) for p in drawn_i420]


def _read_mp4(path):
    with MP4Reader(path) as r:
        return list(r.i420_frames()), r.fps


def _smooth(n, hw, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    return [np.clip(np.stack([128 + 60 * np.sin((x + 4 * t) / 11.0),
                              128 + 50 * np.cos(y / 9.0 + t / 5.0),
                              128 + 70 * np.sin((x + y + 3 * t) / 17.0)], -1)
                    + rng.normal(0, 2, (*hw, 3)), 0, 255).astype(np.uint8)
            for t in range(n)]


def test_run_synthetic_writes_mp4(tmp_path, small_nets):
    hw = (96, 160)
    out = str(tmp_path / "synthetic_out.mp4")
    assert app.run_synthetic(out, frames=3, frame_hw=hw, device="cpu") == 3
    rng = np.random.default_rng(0)
    drawn = _loop(small_nets, hw, [rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
                                   for _ in range(3)])
    want = _reconstructed(drawn, hw, str(tmp_path / "again.mp4"))
    got, fps = _read_mp4(out)
    assert fps == 30.0 and len(got) == 3
    for g, w, d in zip(got, want, drawn):
        np.testing.assert_array_equal(g, w)
        assert _psnr(g[:hw[0]], d[:hw[0]]) >= NOISE_PSNR_DB
    cap = cv2.VideoCapture(out)
    assert cap.get(cv2.CAP_PROP_FPS) == 30.0 and cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3


@pytest.mark.parametrize("src_suffix", [".mp4", ".y4m"])
def test_run_video_reads_and_writes_mp4_at_30_fps(tmp_path, small_nets, src_suffix):
    """An input at 12 fps gives an .mp4 at 30 fps, as the JAX package
    writes it, of the frames drawn over the decoded input."""
    hw = (96, 160)
    src, out = str(tmp_path / f"in{src_suffix}"), str(tmp_path / "in_out.mp4")
    writer = MP4Writer if src_suffix == ".mp4" else Y4MWriter
    with writer(src, hw[1], hw[0], 12.0) as w:
        for f in _smooth(4, hw, seed=4):
            w.write(f)
    assert app.run_video(src, out, device="cpu", max_frames=3) == 3
    reader = MP4Reader if src_suffix == ".mp4" else Y4MReader
    with reader(src) as r:
        assert r.fps == 12.0
        decoded = [r.read() for _ in range(3)]
    drawn = _loop(small_nets, hw, decoded)
    want = _reconstructed(drawn, hw, str(tmp_path / "again.mp4"))
    got, fps = _read_mp4(out)
    assert fps == 30.0 and len(got) == 3
    for g, w, d in zip(got, want, drawn):
        np.testing.assert_array_equal(g, w)
        assert _psnr(g[:hw[0]], d[:hw[0]]) >= SMOOTH_PSNR_DB


def test_main_writes_jax_default_names(tmp_path, small_nets, monkeypatch):
    hw = (96, 160)
    src = tmp_path / "drive.mp4"
    with MP4Writer(str(src), hw[1], hw[0]) as w:
        for f in _smooth(3, hw, seed=6):
            w.write(f)
    app.main(["-i", str(src), "--device", "cpu", "--max-frames", "2"])
    got, fps = _read_mp4(str(tmp_path / "drive_out.mp4"))
    assert len(got) == 2 and fps == 30.0
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(app, "run_synthetic",
                        lambda out, frames, device: (calls.append((out, frames, device)), 0)[1])
    calls = []
    app.main(["--synthetic", "--frames", "2", "--device", "cpu"])
    assert calls == [("synthetic_out.mp4", 2, "cpu")]
    with pytest.raises(NotImplementedError, match="video file"):
        app.main(["--display", "-i", str(src)])


@pytest.mark.parametrize("src_suffix", [".mp4", ".h264"])
def test_run_video_reads_h264(tmp_path, small_nets, src_suffix):
    """``run_video`` over an H.264 clip (an I_PCM IDR, then P pictures of a
    quarter-sample pan) writes one drawn frame for every frame cv2 reads,
    drawn over the port's decode, which is cv2's to the bit in Y."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video"))
    import h264_writer as hw

    hw_ = (96, 160)
    stream = hw.content(bgr_to_i420(_smooth(1, hw_, seed=7)[0]), n_p=3, pan=(6, -3))
    src, out = str(tmp_path / f"clip{src_suffix}"), str(tmp_path / "clip_out.y4m")
    if src_suffix == ".mp4":
        hw.to_mp4(stream, src, fps=12.0)
    else:
        with open(src, "wb") as f:
            f.write(stream)
    ys = _cv2_frames_y(src)
    assert app.run_video(src, out, device="cpu") == len(ys) == 4
    from adas_tpu_torch.render.video import open_reader

    with open_reader(src) as r:
        assert r.fps == (12.0 if src_suffix == ".mp4" else 25.0)
        decoded = list(r.i420_frames())
    for d, y in zip(decoded, ys):
        np.testing.assert_array_equal(d[:hw_[0]], y)
    from adas_tpu_torch.native.draw import i420_to_bgr

    want = _loop(small_nets, hw_, [i420_to_bgr(d, *hw_) for d in decoded])
    with Y4MReader(out) as r:
        got = list(r.i420_frames())
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("src_suffix", [".mp4", ".h264"])
def test_run_video_reads_h264_b_pictures(tmp_path, small_nets, src_suffix):
    """``run_video`` over an H.264 clip with B pictures (an I_PCM IDR, then
    the pan as IBBP with a reference B; an ``avc1`` MP4 with ``ctts`` and
    ``elst``, or Annex B) writes one drawn frame for every frame cv2 reads,
    in cv2's order, drawn over the port's decode, which is cv2's to the bit
    in Y."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video"))
    import h264_writer as hw

    hw_ = (96, 160)
    stream = hw.content(bgr_to_i420(_smooth(1, hw_, seed=8)[0]), n_p=5, pan=(6, -3), bframes=2)
    src, out = str(tmp_path / f"clip{src_suffix}"), str(tmp_path / "clip_out.y4m")
    if src_suffix == ".mp4":
        hw.to_mp4(stream, src, fps=12.0)
    else:
        with open(src, "wb") as f:
            f.write(stream)
    ys = _cv2_frames_y(src)
    assert app.run_video(src, out, device="cpu") == len(ys) == 6
    from adas_tpu_torch.render.video import open_reader

    with open_reader(src) as r:
        decoded = list(r.i420_frames())
        assert r.stats()["b_slices"] == 3 and r.stats()["reference_b_pictures"] == 1
    for d, y in zip(decoded, ys):
        np.testing.assert_array_equal(d[:hw_[0]], y)
    from adas_tpu_torch.native.draw import i420_to_bgr

    want = _loop(small_nets, hw_, [i420_to_bgr(d, *hw_) for d in decoded])
    with Y4MReader(out) as r:
        got = list(r.i420_frames())
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _cv2_frames_y(path):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def _cv2_write(path, frames, fourcc, fps=12.0):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()


def test_run_video_reads_and_writes_avi(tmp_path, small_nets):
    """``run_video`` over cv2's Motion JPEG AVI at 12 fps writes an ``.avi``
    at 30 fps that cv2 reads whole: each frame the writer's reconstruction
    of the frame drawn over the port's decode, within the MP4 writer's PSNR
    bound.  (Every AVI and Motion JPEG input decodes to cv2's Y in
    ``test_torch_avi.py`` and ``test_torch_mjpeg.py``.)"""
    from adas_tpu_torch.render.video import open_reader

    hw = (96, 160)
    src, out = str(tmp_path / "in.avi"), str(tmp_path / "in_out.avi")
    _cv2_write(src, _smooth(3, hw, seed=9), "MJPG")
    assert app.run_video(src, out, device="cpu", max_frames=2) == 2
    with open_reader(src) as r:
        assert r.fps == 12.0 and r.codec == "mjpeg"
        decoded = [r.read() for _ in range(2)]
    drawn = _loop(small_nets, hw, decoded)
    want = _reconstructed(drawn, hw, str(tmp_path / "again.mp4"))
    got = _cv2_frames_y(out)
    cap = cv2.VideoCapture(out)
    assert cap.get(cv2.CAP_PROP_FPS) == 30.0 and len(got) == 2
    for g, w, d in zip(got, want, drawn):
        np.testing.assert_array_equal(g, w[:hw[0]])
        assert _psnr(g, d[:hw[0]]) >= SMOOTH_PSNR_DB


def test_main_reads_avi_and_writes_the_jax_default_name(tmp_path, monkeypatch):
    """``-i drive.avi`` writes ``drive_out.mp4`` (the JAX CLI's name) and
    ``-o`` may name an ``.avi``."""
    calls = []
    monkeypatch.setattr(app, "run_video",
                        lambda src, out, max_frames, device: (calls.append((src, out)), 0)[1])
    src = str(tmp_path / "drive.avi")
    app.main(["-i", src, "--device", "cpu"])
    app.main(["-i", src, "-o", str(tmp_path / "x.avi"), "--device", "cpu"])
    assert calls == [(src, str(tmp_path / "drive_out.mp4")), (src, str(tmp_path / "x.avi"))]
