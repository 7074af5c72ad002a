"""MP4 display matrices (``render/mp4.py`` ``display_matrix`` /
``display_rotation``, ``render/video.MP4Reader``) against
``cv2.VideoCapture``, which turns the frames of a track whose ``tkhd``
matrix (after ``mvhd``'s) turns the picture by 90, 180 or 270 degrees and
reports the turned size (``CAP_PROP_ORIENTATION_AUTO``, on by default).

Bound: cv2's reported width and height, and each frame's Y plane to the
bit (``CAP_PROP_CONVERT_RGB`` 0 gives the decoded luma, turned as the
frames are), as ``test_torch_mp4`` holds the unturned files.  The
fixtures (``tests/data/video/rotated``, by its ``make_fixtures.py
rotated``) patch cv2's own ``mp4v`` files: 90, 180 and 270 degrees, a
mirror (which cv2 reads as a half turn), 30 degrees (left as decoded), and
a ``mvhd`` turn under a ``tkhd`` one; seeded matrices of every kind are
patched in during the test.  BGR frames are the turned frames of the
file unturned; a Motion JPEG track is turned in BGR and refuses to give
its planes turned; the writer keeps the identity matrix.
"""
import glob
import hashlib
import json
import os
import random
import struct
import sys

import cv2
import numpy as np
import pytest

from adas_tpu_torch.render import mp4
from adas_tpu_torch.render.video import MP4Reader, MP4Writer, turn

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
ROTATED = os.path.join(DATA, "rotated")
sys.path.insert(0, DATA)
from make_fixtures import TURNS, patch_matrices  # noqa: E402

with open(os.path.join(ROTATED, "sha256.json")) as _f:
    DIGESTS = json.load(_f)


def _cv2(path):
    """cv2's reported (width, height) and Y planes."""
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    size = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    ys = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        ys.append(f.copy())
    cap.release()
    return size, ys


def _port(path):
    with MP4Reader(path) as r:
        return (r.width, r.height), [p[:r.height] for p in r.i420_frames()], r.rotation


def test_rotated_fixtures_are_committed():
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROTATED, "*.mp4")))
    assert names == sorted(DIGESTS) and len(names) == 6


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_rotated_fixture_equals_cv2(name):
    path = os.path.join(ROTATED, name)
    want = DIGESTS[name]
    size, ys, rotation = _port(path)
    assert size == (want["width"], want["height"])
    assert [hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"]
    cv2_size, cv2_ys = _cv2(path)
    assert cv2_size == size and len(cv2_ys) == len(ys)
    for a, b in zip(ys, cv2_ys):
        np.testing.assert_array_equal(a, b)
    assert (rotation in (90, 270)) == (size[0] < size[1])  # the sources are landscape


@pytest.mark.parametrize("seed", range(3))
def test_random_display_matrices_equal_cv2(tmp_path, seed):
    """Seeded ``tkhd`` and ``mvhd`` matrices: quarter turns, mirrors,
    scales, shears, zero rows, angles near and off the quarters."""
    rng = random.Random(seed)
    with open(os.path.join(DATA, "cv2_noise_64x48.mp4"), "rb") as f:
        source = f.read()
    one = 1 << 16
    picks = list(TURNS.values()) + [(one, 0, 0, one), (0, one, one, 0), (0, 0, 0, 0),
                                    (2 * one, 0, 0, 3 * one), (one, one, 0, one)]
    seen = set()
    for i in range(10):
        def matrix():
            if rng.random() < 0.6:
                return rng.choice(picks)
            angle = rng.choice([rng.uniform(0, 360), rng.choice([89.6, 90.4, 179.5, 270.49])])
            c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
            k = rng.choice([1, 2])
            return tuple(int(round(v * one * k)) for v in (c, s, -s, c))
        path = str(tmp_path / f"m{i}.mp4")
        with open(path, "wb") as f:
            f.write(patch_matrices(source, matrix(), matrix() if rng.random() < 0.4 else None))
        size, ys, rotation = _port(path)
        cv2_size, cv2_ys = _cv2(path)
        assert size == cv2_size and len(ys) == len(cv2_ys) == 4, (i, rotation)
        for a, b in zip(ys, cv2_ys):
            np.testing.assert_array_equal(a, b)
        seen.add(rotation)
    assert len(seen) >= 2


def test_bgr_frames_are_the_turned_frames():
    path = os.path.join(ROTATED, "smooth_176x144_rot90.mp4")
    with MP4Reader(path) as r, MP4Reader(os.path.join(DATA, "cv2_smooth_176x144.mp4")) as plain:
        assert (r.width, r.height, r.fps, len(r)) == (144, 176, plain.fps, len(plain))
        for a, b in zip(r, plain):
            np.testing.assert_array_equal(a, turn(b, 90))


def test_turned_motion_jpeg_reads_bgr_and_refuses_planes(tmp_path):
    """cv2's ``MJPG`` in an ``.mp4`` with a quarter turn: ``read()`` turns
    the BGR frames; the decoded planes (4:2:2 as often as 4:2:0) are not
    turned, so ``read_planes`` refuses by name."""
    src = os.path.join(DATA, "avi", "cv2_mjpg_96x64.mp4")
    path = str(tmp_path / "mjpg_rot270.mp4")
    with open(src, "rb") as f:
        data = patch_matrices(f.read(), TURNS[270])
    with open(path, "wb") as f:
        f.write(data)
    (cv2_w, cv2_h), _ = _cv2(path)
    with MP4Reader(path) as r, MP4Reader(src) as plain:
        assert (r.width, r.height) == (cv2_w, cv2_h) == (plain.height, plain.width)
        frames = list(r)
        assert len(frames) == len(plain) and frames
        for a, b in zip(frames, plain):
            np.testing.assert_array_equal(a, turn(b, 270))
    with MP4Reader(path) as r:
        with pytest.raises(ValueError, match="turns its frames by 270 degrees"):
            r.read_planes()


def test_writer_keeps_the_identity_matrix(tmp_path):
    path = str(tmp_path / "w.mp4")
    with MP4Writer(path, 64, 32) as vw:
        for i in range(2):
            vw.write(np.full((32, 64, 3), 40 * i, np.uint8))
    with open(path, "rb") as f:
        data = f.read()
    for kind, offset in ((b"tkhd", 40), (b"mvhd", 36)):
        at = data.index(kind) + 4 + offset
        assert struct.unpack_from(">9i", data, at) == mp4.IDENTITY
    with MP4Reader(path) as r:
        assert (r.rotation, r.width, r.height) == (0, 64, 32)


@pytest.mark.parametrize("matrix,want", [
    (mp4.IDENTITY, 0), ((0, 1 << 16, 0, -(1 << 16), 0, 0, 0, 0, 1 << 30), 90),
    ((-(1 << 16), 0, 0, 0, -(1 << 16), 0, 0, 0, 1 << 30), 180),
    ((0, -(1 << 16), 0, 1 << 16, 0, 0, 0, 0, 1 << 30), 270), ((0,) * 9, 0)])
def test_display_rotation(matrix, want):
    assert mp4.display_rotation(mp4.display_matrix(matrix, mp4.IDENTITY)) == want
