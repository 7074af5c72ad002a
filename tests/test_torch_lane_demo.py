"""The port's lane demo (``adas_tpu_torch/pipeline/lane_demo.py``) and
``quantize --calib-dir`` (``adas_tpu_torch/tools/quantize.py``) against
the JAX package's, both on the port's cv2-free image codec
(``render/image.py``).

* ``run_lane_image``: the reduced-CULane UFLDv2 of ``test_torch_slice``
  (one weight file for both packages) on a seeded 180x320 PNG; the
  annotated image equals JAX's on >= 99.5% of its pixels (the HUD bound
  of ``test_torch_app``: a point or the area's edge a pixel apart), and
  the file the port writes reads back through cv2 as the returned array.
* ``run_lane_video``: a 3-frame ``.y4m`` through the port; each written
  frame is the facade's ``AutoDrawLanes`` of the decoded input frame
  through the I420 of the file, to the bit.  The same from an ``.mp4`` to
  an ``.mp4`` (and through the CLI): each frame read back is the writer's
  reconstruction of the drawn frame, at 30 fps as the JAX package writes
  it.
* The kinds cv2 turns or that the port reads since its codec grew: a
  progressive JPEG with EXIF Orientation 6 through ``run_lane_image`` to a
  ``.jpg`` (>= 99.5% of JAX's pixels; the file is ``cv2.imencode('.jpg',
  got)``'s bytes), and ``run_lane_video`` over an MP4 whose display matrix
  turns it a quarter (JAX's frame count and frame size, read back by cv2).
* ``quantize --mode int8 --calibrate YOLOV8 --calib-dir``: JAX's file
  selection (sorted, the image suffixes, the first ``--calib-frames``)
  and letterbox on a directory of a PNG, a BMP, a JPEG and a text file,
  and on one of a progressive JPEG, an EXIF-turned JPEG and cv2's gray
  BMP; the baked activation scales within rtol 2e-2 of JAX's on the same
  files (``test_torch_int8_weights``' calibrator bound: the two stems
  round differently in bf16).
"""
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.pipeline import lane_demo as jax_lane_demo
from adas_tpu.tools import params_io as jax_params_io
from adas_tpu.tools import quantize as jax_quantize
from adas_tpu_torch.models import layers
from adas_tpu_torch.native.draw import i420_to_bgr
from adas_tpu_torch.ops.preprocess import bgr_to_i420
from adas_tpu_torch.pipeline import lane_demo
from adas_tpu_torch.render.image import imread, imwrite
from adas_tpu_torch.render.video import AVIReader, MP4Reader, MP4Writer, Y4MReader, Y4MWriter
from adas_tpu_torch.tools import quantize
from adas_tpu_torch.utils.types import LaneModelType
from test_torch_models import random_flax_weights
from test_torch_slice import CULANE, FRAME_HW, npz_paths, weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests

VIDEO_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")


def _exif6(jpeg):
    """``jpeg`` with an Exif APP1 holding Orientation 6 after its SOI."""
    tiff = b"II" + struct.pack("<HIH", 42, 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) \
        + bytes(4)
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def _frame(seed):
    """A seeded road-like frame: gradients, two strokes and some noise."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) % 256], -1) + rng.integers(-30, 31, (h, w, 3))
    img[(np.abs(x - w / 2 - (y - h / 2) * 0.8) < 3) | (np.abs(x - w / 2 + (y - h / 2) * 0.8) < 3)] = 230
    return np.clip(img, 0, 255).astype(np.uint8)


def test_run_lane_image_matches_jax(weights, tmp_path):
    src, out = str(tmp_path / "road.png"), str(tmp_path / "out.png")
    frame = _frame(1)
    assert cv2.imwrite(src, frame)
    want = jax_lane_demo.run_lane_image(src, config={"model_path": weights["lane"],
                                                     "model_type": CULANE})
    got = lane_demo.run_lane_image(src, out, config={
        "model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE}, device="cpu")
    assert got.shape == want.shape == (*FRAME_HW, 3)
    assert (got != frame).any(axis=-1).mean() > 0.01  # something was drawn
    same = (got == want).all(axis=-1).mean()
    assert same >= 0.995, same
    np.testing.assert_array_equal(cv2.imread(out), got)
    with pytest.raises(FileNotFoundError):
        lane_demo.run_lane_image(str(tmp_path / "missing.png"), device="cpu")


def test_run_lane_video_draws_every_frame(weights, tmp_path):
    src, out = str(tmp_path / "in.y4m"), str(tmp_path / "out.y4m")
    h, w = FRAME_HW
    with Y4MWriter(src, w, h, 25.0) as vw:
        for i in range(4):
            vw.write(_frame(10 + i))
    config = {"model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE}
    assert lane_demo.run_lane_video(src, out, config=config, max_frames=3, device="cpu") == 3
    detector = lane_demo.make_lane_detector(dict(config, device="cpu"))
    with Y4MReader(src) as frames, Y4MReader(out) as written:
        assert written.fps == frames.fps
        outs = list(written)
        assert len(outs) == 3
        for frame, got in zip(frames, outs):
            want = detector.AutoDrawLanes(frame)
            np.testing.assert_array_equal(got, i420_to_bgr(bgr_to_i420(want), h, w))
    with pytest.raises(NotImplementedError, match="window"):
        lane_demo.run_lane_video(src, display=True, device="cpu")


def test_run_lane_video_reads_and_writes_mp4(weights, tmp_path):
    src, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    h, w = FRAME_HW
    with MP4Writer(src, w, h, 25.0) as vw:
        for i in range(4):
            vw.write(_frame(40 + i))
    config = {"model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE}
    assert lane_demo.run_lane_video(src, out, config=config, max_frames=3, device="cpu") == 3
    detector = lane_demo.make_lane_detector(dict(config, device="cpu"))
    with MP4Reader(src) as frames:
        assert frames.fps == 25.0
        drawn = [bgr_to_i420(detector.AutoDrawLanes(frames.read())) for _ in range(3)]
    with MP4Writer(str(tmp_path / "again.mp4"), w, h) as vw:
        want = [vw.write_i420(p) for p in drawn]
    with MP4Reader(out) as written:
        assert written.fps == 30.0
        got = list(written.i420_frames())
    assert len(got) == 3
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    cli_out = str(tmp_path / "cli.mp4")
    lane_demo.main(["-i", src, "-o", cli_out, "--max-frames", "2", "--device", "cpu"])
    with MP4Reader(cli_out) as r:
        assert r.fps == 30.0 and len(list(r)) == 2


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_run_lane_video_raises_what_the_stem_raises(weights, tmp_path, monkeypatch, error):
    """A stem that fails (as a kernel's build or launch would) stops the
    loop with its error: no frame is skipped over it."""
    src = str(tmp_path / "in.y4m")
    h, w = FRAME_HW
    with Y4MWriter(src, w, h, 25.0) as vw:
        vw.write(_frame(30))

    def failing_stem(*args, **kwargs):
        raise error("stem kernel launch failed")

    monkeypatch.setattr(layers, "fused_stem", failing_stem)
    config = {"model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE}
    with pytest.raises(error, match="stem kernel launch failed"):
        lane_demo.run_lane_video(src, config=config, device="cpu")


def test_run_lane_image_progressive_exif_jpeg_matches_jax(weights, tmp_path):
    """A progressive JPEG stored a quarter turn left with Orientation 6
    (cv2 reads it upright) to ``out.jpg``."""
    src, out = str(tmp_path / "road.jpg"), str(tmp_path / "out.jpg")
    frame = _frame(2)
    stored = cv2.imencode(".jpg", np.ascontiguousarray(np.rot90(frame)),
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with open(src, "wb") as f:
        f.write(_exif6(stored))
    assert cv2.imread(src).shape == (*FRAME_HW, 3)
    want = jax_lane_demo.run_lane_image(src, config={"model_path": weights["lane"],
                                                     "model_type": CULANE})
    got = lane_demo.run_lane_image(src, out, config={
        "model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE}, device="cpu")
    assert got.shape == want.shape == (*FRAME_HW, 3)
    np.testing.assert_array_equal(imread(src), cv2.imread(src))
    same = (got == want).all(axis=-1).mean()
    assert same >= 0.995, same
    with open(out, "rb") as f:
        assert f.read() == cv2.imencode(".jpg", got)[1].tobytes()


def test_run_lane_video_rotated_mp4_matches_jax(weights, tmp_path):
    """An ``.mp4`` whose display matrix turns it 90 degrees: the port's and
    JAX's demos write as many frames, of the turned size."""
    src = os.path.join(VIDEO_DATA, "rotated", "smooth_176x144_rot90.mp4")
    got_path, want_path = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    n_want = jax_lane_demo.run_lane_video(src, want_path, config={
        "model_path": weights["lane"], "model_type": CULANE}, max_frames=3)
    n_got = lane_demo.run_lane_video(src, got_path, config={
        "model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE},
        max_frames=3, device="cpu")
    assert n_got == n_want == 3
    sizes = []
    for path in (got_path, want_path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f.shape)
        cap.release()
        sizes.append(frames)
    assert sizes[0] == sizes[1] == [(176, 144, 3)] * 3


def test_run_lane_video_xvid_asp_avi_matches_jax(weights, tmp_path):
    """An XviD AVI of MPEG-4 Advanced Simple video (B-VOPs, 4MV,
    quarter-sample vectors, MPEG matrices, XviD's user data and IDCT; the
    seeded stream writer's, which cv2 cannot write): the port's and JAX's
    demos read as many frames in the same order, the Y planes each decodes
    equal to the bit, and write as many frames of one size.  The facade's
    config names the weights and the model type on both sides."""
    sys.path.insert(0, VIDEO_DATA)
    import mpeg4_writer

    src = str(tmp_path / "asp.avi")
    planes = mpeg4_writer.pan_frames(bgr_to_i420(_frame(5)), 7, (6, 2))
    stream = mpeg4_writer.content(planes, (6, 2), frames=7, bframes=2)
    mpeg4_writer.to_avi(stream, src, b"XVID")
    ys = []
    with AVIReader(src) as r:
        while (p := r.read_planes()) is not None:
            ys.append(p[:FRAME_HW[0]])
        assert r.stats()["b_vops"] and r.stats()["inter4v_mbs"] and r.stats()["qpel_vops"]
    cap = cv2.VideoCapture(src)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    want = []
    while (f := cap.read())[0]:
        want.append(f[1])
    cap.release()
    assert len(ys) == len(want) == 7
    for a, b in zip(ys, want):
        np.testing.assert_array_equal(a, b)
    got_path, want_path = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    n_want = jax_lane_demo.run_lane_video(src, want_path, config={
        "model_path": weights["lane"], "model_type": CULANE}, max_frames=7)
    n_got = lane_demo.run_lane_video(src, got_path, config={
        "model_path": weights["lane"], "model_type": LaneModelType.UFLDV2_CULANE},
        max_frames=7, device="cpu")
    assert n_got == n_want == 7
    shapes = []
    for path in (got_path, want_path):
        cap = cv2.VideoCapture(path)
        frames = []
        while (f := cap.read())[0]:
            frames.append(f[1].shape)
        cap.release()
        shapes.append(frames)
    assert shapes[0] == shapes[1] == [(*FRAME_HW, 3)] * 7


def _calib_dir_matches_jax(tmp_path, monkeypatch, write_files):
    """The int8 scales ``quantize --calib-dir`` bakes from the first three
    image files of a directory ``write_files(dir)`` fills, the port's
    against JAX's."""
    flat = random_flax_weights(JaxYoloV8(JaxYoloSpec("v8", "n", 80, (64, 64))), (1, 64, 64, 3),
                               seed=43)
    npz = str(tmp_path / "yolov8n.npz")
    jax_params_io.save_params(npz, jax_params_io.unflatten_variables(flat))
    calib = tmp_path / "calib"
    calib.mkdir()
    write_files(calib)
    got_path, want_path = str(tmp_path / "port_int8.npz"), str(tmp_path / "jax_int8.npz")
    args = ["-i", npz, "--mode", "int8", "--calibrate", "YOLOV8", "--scale", "n",
            "--calib-dir", str(calib), "--calib-frames", "3"]
    quantize.main(args + ["-o", got_path, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["quantize"] + args + ["-o", want_path])
    jax_quantize.main()
    got = jax_params_io.flatten_variables({"a": jax_quantize.load_int8(got_path)["act_scales"]})
    want = jax_params_io.flatten_variables({"a": jax_quantize.load_int8(want_path)["act_scales"]})
    assert set(got) == set(want) and len(want) > 50
    for k, v in want.items():
        dev = abs(float(got[k]) / float(v) - 1)
        assert dev < 2e-2, (k, dev)
    return calib, got_path


def test_calib_dir_matches_jax(tmp_path, monkeypatch):
    frames = [_frame(20 + i) for i in range(4)]

    def write_files(calib):
        # sorted: a.png, b.bmp, c.jpg (the text file is skipped; --calib-frames 3)
        imwrite(str(calib / "a.png"), frames[0])
        imwrite(str(calib / "b.bmp"), frames[1])
        assert cv2.imwrite(str(calib / "c.jpg"), frames[2])
        assert cv2.imwrite(str(calib / "d.png"), frames[3])
        (calib / "notes.txt").write_text("not an image")

    calib, got_path = _calib_dir_matches_jax(tmp_path, monkeypatch, write_files)
    # the first three files by name, and only images
    hw = (640, 640)
    used = list(quantize.calib_dir_frames(str(calib), 3, hw, device="cpu"))
    assert len(used) == 3 and tuple(used[0].shape) == (1, 3, *hw)
    with pytest.raises(SystemExit, match="no image files"):
        list(quantize.calib_dir_frames(str(tmp_path), 3, hw, device="cpu"))
    assert imread(str(calib / "c.jpg")).shape == (*FRAME_HW, 3)
    assert os.path.exists(got_path)


def test_calib_dir_progressive_exif_and_gray_bmp_match_jax(tmp_path, monkeypatch):
    """A progressive JPEG, a JPEG with EXIF Orientation 6 (read turned, as
    cv2 reads it) and cv2's 8-bit gray BMP."""
    frames = [_frame(30 + i) for i in range(3)]

    def write_files(calib):
        assert cv2.imwrite(str(calib / "a.jpg"), frames[0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        turned = cv2.imencode(".jpg", np.ascontiguousarray(np.rot90(frames[1])))[1].tobytes()
        (calib / "b.jpeg").write_bytes(_exif6(turned))
        assert cv2.imwrite(str(calib / "c.bmp"), frames[2][..., 1])

    calib, _ = _calib_dir_matches_jax(tmp_path, monkeypatch, write_files)
    for name in ("a.jpg", "b.jpeg", "c.bmp"):
        path = str(calib / name)
        np.testing.assert_array_equal(imread(path), cv2.imread(path))
    assert imread(str(calib / "b.jpeg")).shape == (*FRAME_HW, 3)
