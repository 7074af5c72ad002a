"""Writes the video codec's fixtures beside this file: small ``mp4v``
``.mp4`` files and cv2's decodes of them.  Needs cv2 (built with FFmpeg);
run from the repository root:

    python tests/data/video/make_fixtures.py

By ``cv2.VideoWriter(path, fourcc "mp4v", 30.0, size)`` from seeded
frames:

- ``cv2_smooth_176x144.mp4``: smooth content panning 3 px a frame over a
  static band (not_coded macroblocks), with a noise patch that appears in
  a few P-VOPs (intra macroblocks in P-VOPs);
- ``cv2_fast_100x58.mp4``: a size that is not a multiple of 16, content
  moving 21 px a frame (f_code 2, vectors out of the picture);
- ``cv2_noise_64x48.mp4``: seeded noise.

By the port's own encoder (``render/video.MP4Writer``), since cv2's writer
never turns AC prediction on: ``port_smooth_176x144.mp4``.

In ``h264/`` (``python tests/data/video/make_fixtures.py h264`` writes
only these), H.264 streams of the stream writer ``h264_writer.py`` (cv2
cannot encode H.264 here): exerciser streams of random legal syntax in
CAVLC (``cavlc_100x58.h264``, Annex B) and CABAC (``cabac_176x144.mp4``,
``avc1``; ``cabac_avc3_64x48.mp4``, ``avc3``), and with B pictures
(``cavlc_b_96x64.h264``, Annex B without the VUI's reorder depth;
``cabac_b_112x64.mp4``, ``avc1`` with ``ctts``), with cv2's Y sha256 per
frame in ``h264/sha256.json``; and there too the digests of cv2's decode
of the content clips ``h264_writer.content_720p()`` (an I_PCM IDR of
``tests/data/images/frame_720p.png``, then P pictures of a quarter-sample
pan) and ``content_720p_b()`` (the pan coded IBBBP with a B pyramid),
which are not committed: the writer is deterministic, so a host without
cv2 rebuilds them and checks their decode against the digests.

In ``avi/`` (``python tests/data/video/make_fixtures.py avi`` writes only
these), the AVI and Motion JPEG fixtures: by ``cv2.VideoWriter`` from
seeded smooth frames, ``mp4v``, ``XVID`` and ``MJPG`` AVIs and ``MJPG`` in
a ``.mov`` (a ``jpeg`` entry) and an ``.mp4`` (an ``mp4v`` entry of object
type 0x6C), with each file's sha256, cv2's frame count, rate and Y sha256
per frame in ``avi/sha256.json``; and there too the digests of cv2's
decode of the 720p Motion JPEG clip ``avi_clips.mjpeg_720p`` whole and
damaged, which is not committed: the port's muxer rebuilds it from the
committed JPEGs.

Beside them, for every file, cv2's decode: the Y planes
(``cv2.VideoCapture`` with ``CAP_PROP_CONVERT_RGB`` 0 returns the decoded
luma plane) as ``<name>_y.npy`` for the two small files and as a sha256
per frame in ``sha256.json`` for all; and ``cv2_fast_100x58_bgr.npy``,
cv2's BGR frames of that file (the chroma bound's reference where cv2 is
absent).
"""
import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from adas_tpu_torch.render.video import MP4Writer  # noqa: E402


def smooth(n, h, w, speed, seed, static_rows=0, patch=()):
    """Seeded smooth frames panning ``speed`` px a frame; the last
    ``static_rows`` rows never change; a noise patch in the frames of
    ``patch``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    grain = rng.normal(0, 2, (n, h, w, 3))
    still = None
    frames = []
    for t in range(n):
        xs = x + speed * t
        b = 128 + 60 * np.sin(xs / 13.0) * np.cos(y / 17.0) + 40 * np.sin((xs + y) / 29.0)
        g = 128 + 70 * np.cos(xs / 23.0) + 30 * np.sin(y / 7.0)
        r = 128 + 80 * np.sin((xs - 2 * y) / 31.0)
        img = np.clip(np.stack([b, g, r], -1) + grain[t], 0, 255).astype(np.uint8)
        if static_rows:
            if still is None:
                still = img[h - static_rows:].copy()
            img[h - static_rows:] = still
        if t in patch:
            img[8:40, 16:64] = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        frames.append(img)
    return frames


def cv2_write(path, frames):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()


def cv2_decode(path, convert_rgb):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 1 if convert_rgb else 0)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.copy())
    cap.release()
    return np.stack(frames)


FIXTURES = {
    "cv2_smooth_176x144": lambda: smooth(30, 144, 176, 3, 1, static_rows=48, patch=(5, 6, 17)),
    "cv2_fast_100x58": lambda: smooth(24, 58, 100, 21, 2),
    "cv2_noise_64x48": lambda: list(np.random.default_rng(3).integers(0, 256, (4, 48, 64, 3),
                                                                       dtype=np.uint8)),
    "port_smooth_176x144": lambda: smooth(24, 144, 176, 5, 4, static_rows=32, patch=(14,)),
}
#: the files whose Y planes are committed as .npy (the others by sha256 only)
NPY = ("cv2_fast_100x58", "cv2_noise_64x48")


H264_DIR = os.path.join(HERE, "h264")
#: the H.264 exerciser fixtures: file name -> (writer options, MP4 sample entry or None)
H264_FIXTURES = {
    "cavlc_100x58.h264": (dict(seed=11, cabac=0, frames=8, width=100, height=58, refs=3,
                               ref_mods=1, mmco=1, long_term=1, slices=3, deblock=2, nonref=1,
                               pcm=5, weighted=1, scaling=1), None),
    "cabac_176x144.mp4": (dict(seed=12, cabac=1, frames=8, width=176, height=144, refs=2,
                               weighted=1, scaling=2, slices=2, deblock=2, mmco=2), b"avc1"),
    "cabac_avc3_64x48.mp4": (dict(seed=13, cabac=1, frames=6, width=64, height=48, poc_type=2,
                                  nonref=1, cip=1, intra_in_p=30), b"avc3"),
    # B pictures: Annex B without the VUI's reorder depth, and avc1 with ctts
    "cavlc_b_96x64.h264": (dict(seed=21, cabac=0, frames=14, width=96, height=64, bframes=3,
                                pyramid=1, direct=2, bipred=2, refs=3, ref_mods=1, slices=2,
                                deblock=2), None),
    "cabac_b_112x64.mp4": (dict(seed=22, cabac=1, frames=14, width=112, height=64, bframes=2,
                                pyramid=1, direct=2, bipred=1, refs=3, mmco=1, long_term=1,
                                slices=2, deblock=2, vui=1), b"avc1"),
}
def h264_main():
    sys.path.insert(0, HERE)
    import h264_writer

    os.makedirs(H264_DIR, exist_ok=True)
    digests = {}
    for name, (options, fourcc) in H264_FIXTURES.items():
        path = os.path.join(H264_DIR, name)
        stream = h264_writer.exercise(**options)
        if fourcc is None:
            with open(path, "wb") as f:
                f.write(stream)
        else:
            h264_writer.to_mp4(stream, path, fourcc)
        ys = cv2_decode(path, False)
        digests[name] = {
            "frames": len(ys), "height": int(ys.shape[1]), "width": int(ys.shape[2]),
            "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
    for name, clip, spec in (("content_720p", h264_writer.content_720p, h264_writer.CONTENT_720P),
                             ("content_720p_b", h264_writer.content_720p_b,
                              h264_writer.CONTENT_720P_B)):
        tmp = os.path.join(H264_DIR, name + ".h264")
        with open(tmp, "wb") as f:
            f.write(clip())
        ys = cv2_decode(tmp, False)
        os.remove(tmp)
        assert len(ys) == spec["frames"]
        digests[name] = {**spec, "height": 720, "width": 1280,
                         "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
    with open(os.path.join(H264_DIR, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


AVI_DIR = os.path.join(HERE, "avi")
#: the cv2-written AVI fixtures: file name -> the writer's fourcc
AVI_FIXTURES = {"cv2_mp4v_96x64.avi": "mp4v", "cv2_xvid_96x64.avi": "XVID",
                "cv2_mjpg_96x64.avi": "MJPG", "cv2_mjpg_96x64.mov": "MJPG",
                "cv2_mjpg_96x64.mp4": "MJPG"}


def _digests(path):
    ys = cv2_decode(path, False)
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return {"frames": len(ys), "height": int(ys.shape[1]), "width": int(ys.shape[2]),
            "fps": fps, "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}


def avi_main():
    sys.path.insert(0, HERE)
    import avi_clips

    os.makedirs(AVI_DIR, exist_ok=True)
    frames = smooth(16, 64, 96, 4, 7, static_rows=16, patch=(9,))
    digests = {}
    for name, fourcc in AVI_FIXTURES.items():
        path = os.path.join(AVI_DIR, name)
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 30.0, (96, 64))
        assert vw.isOpened()
        for f in frames:
            vw.write(f)
        vw.release()
        with open(path, "rb") as f:
            digests[name] = {"sha256": hashlib.sha256(f.read()).hexdigest(), **_digests(path)}
        assert digests[name]["frames"] == len(frames)
    for name, damaged in (("clip_720p_mjpg.avi", False), ("clip_720p_mjpg_damaged.avi", True)):
        tmp = os.path.join(AVI_DIR, name)
        avi_clips.mjpeg_720p(tmp, damaged)
        digests[name] = _digests(tmp)
        os.remove(tmp)
        assert digests[name]["frames"] == avi_clips.FRAMES - damaged
    with open(os.path.join(AVI_DIR, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


def main():
    if sys.argv[1:] == ["h264"]:
        h264_main()
        return
    if sys.argv[1:] == ["avi"]:
        avi_main()
        return
    digests = {}
    for name, make in FIXTURES.items():
        path = os.path.join(HERE, name + ".mp4")
        frames = make()
        if name.startswith("cv2_"):
            cv2_write(path, frames)
        else:
            h, w = frames[0].shape[:2]
            with MP4Writer(path, w, h, 30.0) as vw:
                for f in frames:
                    vw.write(f)
        ys = cv2_decode(path, False)
        assert len(ys) == len(frames), (name, len(ys))
        digests[name + ".mp4"] = {
            "frames": len(ys), "height": int(ys.shape[1]), "width": int(ys.shape[2]),
            "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
        if name in NPY:
            np.save(os.path.join(HERE, name + "_y.npy"), ys)
    np.save(os.path.join(HERE, "cv2_fast_100x58_bgr.npy"),
            cv2_decode(os.path.join(HERE, "cv2_fast_100x58.mp4"), True))
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
