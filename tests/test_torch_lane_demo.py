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
* ``quantize --mode int8 --calibrate YOLOV8 --calib-dir``: JAX's file
  selection (sorted, the image suffixes, the first ``--calib-frames``)
  and letterbox on a directory of a PNG, a BMP, a JPEG and a text file;
  the baked activation scales within rtol 2e-2 of JAX's on the same files
  (``test_torch_int8_weights``' calibrator bound: the two stems round
  differently in bf16).
"""
import os
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
from adas_tpu_torch.render.video import MP4Reader, MP4Writer, Y4MReader, Y4MWriter
from adas_tpu_torch.tools import quantize
from adas_tpu_torch.utils.types import LaneModelType
from test_torch_models import random_flax_weights
from test_torch_slice import CULANE, FRAME_HW, npz_paths, weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests


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


def test_calib_dir_matches_jax(tmp_path, monkeypatch):
    flat = random_flax_weights(JaxYoloV8(JaxYoloSpec("v8", "n", 80, (64, 64))), (1, 64, 64, 3),
                               seed=43)
    npz = str(tmp_path / "yolov8n.npz")
    jax_params_io.save_params(npz, jax_params_io.unflatten_variables(flat))
    calib = tmp_path / "calib"
    calib.mkdir()
    # sorted: a.png, b.bmp, c.jpg (the text file is skipped; --calib-frames 3)
    frames = [_frame(20 + i) for i in range(4)]
    imwrite(str(calib / "a.png"), frames[0])
    imwrite(str(calib / "b.bmp"), frames[1])
    assert cv2.imwrite(str(calib / "c.jpg"), frames[2])
    assert cv2.imwrite(str(calib / "d.png"), frames[3])
    (calib / "notes.txt").write_text("not an image")
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
    # the first three files by name, and only images
    hw = (640, 640)
    used = list(quantize.calib_dir_frames(str(calib), 3, hw, device="cpu"))
    assert len(used) == 3 and tuple(used[0].shape) == (1, 3, *hw)
    with pytest.raises(SystemExit, match="no image files"):
        list(quantize.calib_dir_frames(str(tmp_path), 3, hw, device="cpu"))
    assert imread(str(calib / "c.jpg")).shape == (*FRAME_HW, 3)
    assert os.path.exists(got_path)
