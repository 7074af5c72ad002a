"""Motion JPEG BGR as cv2 gives it (``native/mjpeg.cpp`` ``mjpeg_bgr``
through ``render/video.AVIReader.read``), where x86 libswscale filters
the chroma, on the CPU.

cv2 converts each decoded frame with ``sws_scale(SWS_BICUBIC)`` to BGR24.
4:2:0 and 4:2:2 of even height take the unscaled converter (nearest
chroma); odd heights, 4:4:0 and 4:1:1 take the scaler, whose bicubic
chroma filters, MMX rows, C last rows and full-chroma path for odd widths
and 4:4:4 the port follows.  Every sampling at sizes that take each path,
with restart intervals, the 720p Motion JPEG clip and a 720p frame cut to
odd sides equal cv2's BGR to the bit; so do the committed cases
(``tests/data/video/avi/swscale_cases.npz``: cv2's BGR beside each JPEG,
for hosts without cv2).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.render import mjpeg  # noqa: E402
from adas_tpu_torch.render.video import AVIReader  # noqa: E402
from test_torch_mjpeg import SAMPLINGS, _smooth, cv2_frames, encode, mux  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
sys.path.insert(0, DATA)
import avi_clips  # noqa: E402

#: sizes that take each of swscale's paths: even sides (the unscaled
#: converter for 4:2:0 / 4:2:2), odd height, odd width (full chroma), both
SIZES = [(48, 64), (37, 64), (48, 53), (37, 53), (17, 9)]


def port_bgr(path):
    with AVIReader(path) as r:
        return list(r), r._decoder.format


def assert_bgr_equal(path):
    got, fmt = port_bgr(path)
    want = cv2_frames(path, convert_rgb=True)
    assert len(got) == len(want) > 0
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{fmt} frame {k}")
    return fmt


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_bgr_equals_cv2s(tmp_path, sampling, hw):
    h, w = hw
    frames = [encode(f, sampling) for f in _smooth(2, h, w, seed=5)]
    fmt = assert_bgr_equal(mux(tmp_path / "m.avi", frames, w, h))
    assert fmt == ("gray" if sampling == "gray" else f"yuvj{sampling}p")


@pytest.mark.parametrize("sampling", ["420", "440", "411"])
def test_bgr_with_restarts_and_noise_equals_cv2s(tmp_path, sampling):
    """Restart intervals and noisy frames (chroma with sharp edges, where
    the bicubic filters overshoot and clip) at odd sides."""
    rng = np.random.default_rng(3)
    frames = []
    for f in _smooth(2, 41, 59, seed=2):
        noisy = np.clip(f.astype(int) + rng.integers(-60, 61, f.shape), 0, 255).astype(np.uint8)
        frames.append(encode(noisy, sampling, restart=2, quality=95))
    assert_bgr_equal(mux(tmp_path / "m.avi", frames, 59, 41))


def test_720p_clip_and_odd_sided_720p_equal_cv2s(tmp_path):
    """The 720p Motion JPEG clip (4:2:0 and 4:2:2, the unscaled converter)
    and one of its frames cut to 719x1279 in 4:4:0 and 4:1:1 (the
    scaler)."""
    clip = str(tmp_path / "clip.avi")
    avi_clips.mjpeg_720p(clip)
    assert_bgr_equal(clip)
    with AVIReader(clip) as r:
        frame = r.read()[:719, :1279]
    for sampling in ("440", "411"):
        path = mux(tmp_path / f"{sampling}.avi", [encode(frame, sampling)], 1279, 719)
        assert_bgr_equal(path)


def test_committed_cases_equal_cv2s_bgr():
    cases = np.load(os.path.join(DATA, "avi", "swscale_cases.npz"))
    samplings = sorted(k[5:] for k in cases if k.startswith("jpeg_"))
    assert samplings == ["411", "420", "422", "440", "444"]
    for sampling in samplings:
        d = mjpeg.Decoder()
        d.decode(cases[f"jpeg_{sampling}"].tobytes())
        np.testing.assert_array_equal(d.bgr(), cases[f"bgr_{sampling}"], err_msg=sampling)
        d.close()
