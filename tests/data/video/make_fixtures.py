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

In ``mpeg4/`` (``python tests/data/video/make_fixtures.py mpeg4`` writes
only these), MPEG-4 Advanced Simple streams of the stream writer
``mpeg4_writer.py`` (cv2's writer uses none of these tools), muxed by the
port as AVIs tagged ``XVID`` / ``DX50`` and as ``mp4v`` MP4s
(``MPEG4_FIXTURES``: XviD's IDCT, an XVID tag without user data, XviD's
preset of B-VOPs + 4MV + quarter-sample + MPEG matrices, Lavc's user data
with loaded matrices and video packets, DivX's packed B-VOPs, N-VOPs),
each admitted only when FFmpeg logs no error while cv2 decodes it
(``cv2_errors``), with cv2's frame count and Y sha256 per frame in
``mpeg4/sha256.json``; interlaced ones (``MPEG4_INTERLACED``), for which
cv2 5.0 on FFmpeg 8.1 returns blank frames (its ``sws_scale`` refuses an
interlaced frame), with cv2's count and the sha256 of the Y, U and V
planes of cv2's bundled libavcodec (``libavcodec_planes``, ctypes); and there too the digests of cv2's decode of the
720p content clip ``mpeg4_writer.content_720p()`` as an ``XVID`` AVI, not
committed: the writer is deterministic.

``conceal_sha256.json`` (``python tests/data/video/make_fixtures.py
conceal`` writes only it): the digests of the damaged 720p clips of
``conceal_clips.py`` as cv2's bundled FFmpeg decodes them on one thread
(``libavformat_planes``: cv2's demuxer and stream probe; one thread, as
cv2's frame threads make a concealed picture depend on their timing), not
committed: the writers are deterministic.

In ``rotated/`` (``python tests/data/video/make_fixtures.py rotated`` writes
only these), cv2's ``cv2_smooth_176x144.mp4`` and ``cv2_noise_64x48.mp4``
with their display matrices patched (``patch_matrices``): ``tkhd`` turned
90, 180 and 270 degrees, mirrored, turned 30 degrees, and ``mvhd`` turned
90 degrees under a ``tkhd`` turned 180; with cv2's reported width and
height and Y sha256 per frame (cv2 turns the frames) in
``rotated/sha256.json``.

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
import struct
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


HEVC_DIR = os.path.join(HERE, "hevc")


def hevc_main():
    """cv2's Y digests of the 720p H.265 content clip
    (``hevc_writer.content_720p``), which ``chip_smoke.py`` decodes on the
    card, in ``hevc/sha256.json``."""
    sys.path.insert(0, HERE)
    import hevc_writer

    os.makedirs(HEVC_DIR, exist_ok=True)
    tmp = os.path.join(HEVC_DIR, "content_720p.h265")
    with open(tmp, "wb") as f:
        f.write(hevc_writer.content_720p())
    ys = cv2_decode(tmp, False)
    os.remove(tmp)
    spec = hevc_writer.CONTENT_720P
    assert len(ys) == spec["frames"]
    digests = {"content_720p": {**spec, "height": 720, "width": 1280,
                                "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}}
    with open(os.path.join(HEVC_DIR, "sha256.json"), "w") as f:
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
    clip_digests(digests)


#: Motion JPEG frames whose BGR cv2 converts through swscale's scaler
#: (odd sides, 4:4:0, 4:1:1): sampling -> (height, width), encoded by
#: ``cv2.imencode`` from ``smooth`` content
SWSCALE_CASES = {"420": (37, 53), "422": (45, 70), "440": (48, 64), "411": (37, 64),
                 "444": (17, 9)}
SWSCALE_FACTORS = {"420": 0x221111, "422": 0x211111, "440": 0x121111, "411": 0x411111,
                   "444": 0x111111}


def swscale_main():
    """``avi/swscale_cases.npz``: each case's JPEG and cv2's BGR of it read
    from an ``MJPG`` AVI (the port's muxer), for hosts without cv2."""
    from adas_tpu_torch.render import avi

    out = {}
    for sampling, (h, w) in SWSCALE_CASES.items():
        frame = smooth(1, h, w, 3, 11)[0]
        jpeg = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            SWSCALE_FACTORS[sampling]])[1]
        path = os.path.join(AVI_DIR, "swscale_tmp.avi")
        with avi.Muxer(path, w, h, b"MJPG") as m:
            m.add(jpeg.tobytes(), True)
        bgr = cv2_decode(path, True)
        os.remove(path)
        assert bgr.shape == (1, h, w, 3)
        out[f"jpeg_{sampling}"] = jpeg
        out[f"bgr_{sampling}"] = bgr[0]
    np.savez_compressed(os.path.join(AVI_DIR, "swscale_cases.npz"), **out)


def clip_digests(digests):
    """cv2's digests of the 720p Motion JPEG clip whole and damaged
    (``avi_clips.mjpeg_720p``), into ``avi/sha256.json`` beside
    ``digests``, and cut after its sizes were written, into
    ``avi/cut_sha256.json``; ``make_fixtures.py avi clips`` rewrites only
    these."""
    sys.path.insert(0, HERE)
    import avi_clips

    cut_digests = {}
    for name, damaged, cut in (("clip_720p_mjpg.avi", False, False),
                               ("clip_720p_mjpg_damaged.avi", True, False),
                               ("clip_720p_mjpg_cut.avi", False, True)):
        tmp = os.path.join(AVI_DIR, name)
        avi_clips.mjpeg_720p(tmp, damaged, cut)
        table = cut_digests if cut else digests
        table[name] = _digests(tmp)
        os.remove(tmp)
        assert table[name]["frames"] == avi_clips.FRAMES - damaged
    for file, table in (("sha256.json", digests), ("cut_sha256.json", cut_digests)):
        with open(os.path.join(AVI_DIR, file), "w") as f:
            json.dump(table, f, indent=1)
            f.write("\n")



ROTATED_DIR = os.path.join(HERE, "rotated")
ONE = 1 << 16
#: display matrices (a, b, c, d of the 16.16 upper-left 2x2) in ISO order
TURNS = {90: (0, ONE, -ONE, 0), 180: (-ONE, 0, 0, -ONE), 270: (0, -ONE, ONE, 0),
         "mirror": (-ONE, 0, 0, ONE), 30: (56756, 32768, -32768, 56756)}
#: file name -> (source fixture, tkhd turn, mvhd turn or None)
ROTATED = {
    "smooth_176x144_rot90.mp4": ("cv2_smooth_176x144.mp4", 90, None),
    "noise_64x48_rot180.mp4": ("cv2_noise_64x48.mp4", 180, None),
    "noise_64x48_rot270.mp4": ("cv2_noise_64x48.mp4", 270, None),
    "noise_64x48_mirror.mp4": ("cv2_noise_64x48.mp4", "mirror", None),
    "noise_64x48_rot30.mp4": ("cv2_noise_64x48.mp4", 30, None),
    "noise_64x48_rot180_movie90.mp4": ("cv2_noise_64x48.mp4", 180, 90),
}


def patch_matrices(data, tkhd, mvhd=None):
    """An MP4 (version 0 ``tkhd`` and ``mvhd``, as cv2 writes them) with
    its first track's matrix, and the movie's, set to the (a, b, c, d)
    given."""
    out = bytearray(data)
    for kind, offset, turn in ((b"tkhd", 40, tkhd), (b"mvhd", 36, mvhd)):
        if turn is not None:
            at = out.index(kind) + 4 + offset
            a, b, c, d = turn
            struct.pack_into(">9i", out, at, a, b, 0, c, d, 0, 0, 0, 1 << 30)
    return bytes(out)


def rotated_main():
    os.makedirs(ROTATED_DIR, exist_ok=True)
    digests = {}
    for name, (source, turn, movie) in ROTATED.items():
        with open(os.path.join(HERE, source), "rb") as f:
            data = patch_matrices(f.read(), TURNS[turn], movie and TURNS[movie])
        path = os.path.join(ROTATED_DIR, name)
        with open(path, "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(path)
        width, height = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        ys = cv2_decode(path, False)
        assert ys.shape[1:] == (height, width), (name, ys.shape, width, height)
        digests[name] = {"frames": len(ys), "width": width, "height": height,
                         "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
    with open(os.path.join(ROTATED_DIR, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


MPEG4_DIR = os.path.join(HERE, "mpeg4")
#: the MPEG-4 Advanced Simple fixtures of ``mpeg4_writer.py``: file name ->
#: (writer options, AVI fourcc or None for an MP4)
MPEG4_FIXTURES = {
    # Simple tools with XviD's user data: libavcodec's XviD IDCT
    "xvid_idct_64x48.avi": (dict(seed=1, frames=6, width=64, height=48, user=1, four_mv=0,
                                 intra=20), b"XVID"),
    # no user data in an XVID AVI: XviD build 0 (the edge, DC clip and
    # quarter-sample chroma workarounds)
    "xvid_tag_72x40.avi": (dict(seed=2, frames=8, width=72, height=40, user=3, bframes=2,
                                four_mv=30, qpel=1), b"XVID"),
    # XviD's preset: B-VOPs, 4MV, quarter-sample, MPEG matrices
    "xvid_asp_96x64.avi": (dict(seed=3, frames=10, width=96, height=64, user=1, bframes=2,
                                four_mv=30, qpel=1, mpeg_quant=1), b"XVID"),
    "xvid_asp_96x64.mp4": (dict(seed=3, frames=10, width=96, height=64, user=1, bframes=2,
                                four_mv=30, qpel=1, mpeg_quant=1), None),
    # Lavc: three B-VOPs, loaded matrices, video packets with HEC, half-sample 4MV
    "lavc_packets_80x48.mp4": (dict(seed=4, frames=9, width=80, height=48, user=0, bframes=3,
                                    four_mv=40, mpeg_quant=2, packets=12, hec=50), None),
    # DivX 5.03 packed B-VOPs (build 1393: quarter-sample chroma workarounds)
    "divx_packed_80x64.avi": (dict(seed=5, frames=9, width=80, height=64, user=2, build=1393,
                                   bframes=1, four_mv=30, qpel=1), b"DX50"),
    "divx_packed_80x64.mp4": (dict(seed=5, frames=9, width=80, height=64, user=2, build=1393,
                                   bframes=1, four_mv=30, qpel=1), None),
    # N-VOPs in a low-delay stream, video packets
    "nvop_64x48.avi": (dict(seed=6, frames=8, width=64, height=48, user=0, nvop=40, packets=15,
                            four_mv=30), b"XVID"),
}


#: interlaced fixtures: cv2 5.0 on FFmpeg 8.1 returns blank frames for
#: them (its sws_scale refuses an interlaced frame), so their digests are
#: those of cv2's bundled libavcodec's planes, read through ctypes
MPEG4_INTERLACED = {
    "interlaced_96x64.avi": (dict(seed=8, frames=9, width=96, height=64, user=1, bframes=2,
                                  four_mv=20, qpel=1, mpeg_quant=1, interlaced=1, field_mv=50,
                                  packets=12), b"XVID"),
    "interlaced_lavc56_72x40.mp4": (dict(seed=9, frames=8, width=72, height=40, user=0,
                                         lavc_major=56, bframes=1, interlaced=1, field_mv=60,
                                         outside=40), None),
    "interlaced_xvix_64x48.avi": (dict(seed=10, frames=6, width=64, height=48, user=3,
                                       interlaced=1, xvid_ilace=1, field_mv=60), b"XVIX"),
    "interlaced_divx_80x48.avi": (dict(seed=11, frames=7, width=80, height=48, user=2,
                                       build=2000, bframes=1, interlaced=1, field_mv=60),
                                  b"DX50"),
}


def libavcodec_planes(samples, tag=b"", codec=12):
    """cv2's bundled libavcodec's decode of an ``mp4v`` stream's samples
    (``codec`` 27: H.264 access units) on one thread: each frame's (Y, U,
    V) planes, as FFmpeg gives them before cv2's conversion."""
    import ctypes
    import glob

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    avu = ctypes.CDLL(glob.glob(os.path.join(libs, "libavutil-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(glob.glob(os.path.join(libs, "libavcodec-*.so*"))[0])
    vp = ctypes.c_void_p
    avc.avcodec_find_decoder.restype = vp
    avc.avcodec_alloc_context3.restype, avc.avcodec_alloc_context3.argtypes = vp, [vp]
    avc.avcodec_open2.argtypes = [vp, vp, vp]
    avc.av_packet_alloc.restype = vp
    avc.av_new_packet.argtypes = [vp, ctypes.c_int]
    avc.avcodec_send_packet.argtypes = [vp, vp]
    avc.avcodec_receive_frame.argtypes = [vp, vp]
    avc.av_packet_unref.argtypes = [vp]
    avu.av_frame_alloc.restype = vp
    avu.av_frame_unref.argtypes = [vp]
    avu.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    ctx = avc.avcodec_alloc_context3(avc.avcodec_find_decoder(codec))  # 12: MPEG4, 27: H264
    if tag:  # AVCodecContext.codec_tag
        ctypes.c_uint.from_address(ctx + 28).value = int.from_bytes(tag, "little")
    avu.av_opt_set_int(ctx, b"threads", 1, 0)
    assert avc.avcodec_open2(ctx, avc.avcodec_find_decoder(codec), None) == 0
    pkt, frame = avc.av_packet_alloc(), avu.av_frame_alloc()
    out = []

    def receive():
        while avc.avcodec_receive_frame(ctx, frame) == 0:
            w = ctypes.c_int.from_address(frame + 104).value  # AVFrame width, height
            h = ctypes.c_int.from_address(frame + 108).value
            planes = []
            for i in range(3):
                data = ctypes.c_void_p.from_address(frame + 8 * i).value
                stride = ctypes.c_int.from_address(frame + 64 + 4 * i).value
                ph, pw = (h, w) if i == 0 else ((h + 1) // 2, (w + 1) // 2)
                buf = (ctypes.c_uint8 * (stride * ph)).from_address(data)
                planes.append(np.ctypeslib.as_array(buf).reshape(ph, stride)[:, :pw].copy())
            out.append(planes)
            avu.av_frame_unref(frame)

    for sample in samples:
        avc.av_new_packet(pkt, len(sample))
        ctypes.memmove(ctypes.c_void_p.from_address(pkt + 24).value, sample, len(sample))
        avc.avcodec_send_packet(ctx, pkt)
        avc.av_packet_unref(pkt)
        receive()
    avc.avcodec_send_packet(ctx, None)
    receive()
    return out


def libavformat_planes(path, threads=1):
    """What cv2's bundled FFmpeg decodes of ``path``'s video stream as cv2
    reads it (libavformat's demuxer and stream probe, the decoder opened
    from the stream's parameters), on ``threads`` threads: each frame's
    (Y, U, V) planes before cv2's conversion."""
    import ctypes
    import glob

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    avu = ctypes.CDLL(glob.glob(os.path.join(libs, "libavutil-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(glob.glob(os.path.join(libs, "libavcodec-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    avf = ctypes.CDLL(glob.glob(os.path.join(libs, "libavformat-*.so*"))[0])
    vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    avf.avformat_open_input.argtypes = [pp, ctypes.c_char_p, vp, vp]
    avf.avformat_find_stream_info.argtypes = [vp, vp]
    avf.av_find_best_stream.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp,
                                        ctypes.c_int]
    avf.av_read_frame.argtypes = [vp, vp]
    avf.avformat_close_input.argtypes = [pp]
    avc.avcodec_find_decoder.restype = vp
    avc.avcodec_alloc_context3.restype, avc.avcodec_alloc_context3.argtypes = vp, [vp]
    avc.avcodec_parameters_to_context.argtypes = [vp, vp]
    avc.avcodec_open2.argtypes = [vp, vp, vp]
    avc.av_packet_alloc.restype = vp
    avc.avcodec_send_packet.argtypes = [vp, vp]
    avc.avcodec_receive_frame.argtypes = [vp, vp]
    avc.av_packet_unref.argtypes = [vp]
    avc.avcodec_free_context.argtypes = [pp]
    avu.av_frame_alloc.restype = vp
    avu.av_frame_unref.argtypes = [vp]
    avu.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    fmt = ctypes.c_void_p()
    assert avf.avformat_open_input(ctypes.byref(fmt), path.encode(), None, None) == 0
    assert avf.avformat_find_stream_info(fmt, None) >= 0
    index = avf.av_find_best_stream(fmt, 0, -1, -1, None, 0)  # AVMEDIA_TYPE_VIDEO
    assert index >= 0
    streams = ctypes.c_void_p.from_address(fmt.value + 48).value  # AVFormatContext.streams
    stream = ctypes.c_void_p.from_address(streams + 8 * index).value
    par = ctypes.c_void_p.from_address(stream + 16).value  # AVStream.codecpar
    codec_id = ctypes.c_int.from_address(par + 4).value  # AVCodecParameters.codec_id
    dec = avc.avcodec_find_decoder(codec_id)
    ctx = avc.avcodec_alloc_context3(dec)
    assert avc.avcodec_parameters_to_context(ctx, par) >= 0
    avu.av_opt_set_int(ctx, b"threads", threads, 0)
    assert avc.avcodec_open2(ctx, dec, None) == 0
    pkt, frame = avc.av_packet_alloc(), avu.av_frame_alloc()
    out = []

    def receive():
        while avc.avcodec_receive_frame(ctx, frame) == 0:
            w = ctypes.c_int.from_address(frame + 104).value
            h = ctypes.c_int.from_address(frame + 108).value
            planes = []
            for i in range(3):
                data = ctypes.c_void_p.from_address(frame + 8 * i).value
                stride = ctypes.c_int.from_address(frame + 64 + 4 * i).value
                ph, pw = (h, w) if i == 0 else ((h + 1) // 2, (w + 1) // 2)
                buf = (ctypes.c_uint8 * (stride * ph)).from_address(data)
                planes.append(np.ctypeslib.as_array(buf).reshape(ph, stride)[:, :pw].copy())
            out.append(planes)
            avu.av_frame_unref(frame)

    while avf.av_read_frame(fmt, pkt) >= 0:
        if ctypes.c_int.from_address(pkt + 36).value == index:  # AVPacket.stream_index
            avc.avcodec_send_packet(ctx, pkt)
            receive()
        avc.av_packet_unref(pkt)
    avc.avcodec_send_packet(ctx, None)
    receive()
    avc.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    avf.avformat_close_input(ctypes.byref(fmt))
    return out


def cv2_errors(path):
    """What FFmpeg logs at its error level while cv2 decodes ``path``, in a
    subprocess (cv2 passes ``OPENCV_FFMPEG_LOGLEVEL`` to av_log_set_level)."""
    import subprocess

    code = ("import cv2, sys\ncap = cv2.VideoCapture(sys.argv[1])\n"
            "while cap.read()[0]:\n    pass\n")
    env = {**os.environ, "OPENCV_FFMPEG_LOGLEVEL": "16", "OPENCV_LOG_LEVEL": "ERROR"}
    proc = subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                          env=env, timeout=120)
    return [line for line in proc.stderr.splitlines() if " @ 0x" in line]


def mpeg4_main():
    sys.path.insert(0, HERE)
    import mpeg4_writer

    os.makedirs(MPEG4_DIR, exist_ok=True)
    digests = {}
    for name, (options, fourcc) in MPEG4_FIXTURES.items():
        path = os.path.join(MPEG4_DIR, name)
        stream = mpeg4_writer.exercise(**options)
        if fourcc is None:
            mpeg4_writer.to_mp4(stream, path)
        else:
            mpeg4_writer.to_avi(stream, path, fourcc)
        errors = cv2_errors(path)
        assert not errors, (name, errors)
        ys = cv2_decode(path, False)
        digests[name] = {
            "options": options, "fourcc": fourcc.decode() if fourcc else "mp4v",
            "frames": len(ys), "height": int(ys.shape[1]), "width": int(ys.shape[2]),
            "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
    for name, (options, fourcc) in MPEG4_INTERLACED.items():
        path = os.path.join(MPEG4_DIR, name)
        stream = mpeg4_writer.exercise(**options)
        if fourcc is None:
            mpeg4_writer.to_mp4(stream, path)
        else:
            mpeg4_writer.to_avi(stream, path, fourcc)
        planes = libavcodec_planes(stream.samples, fourcc or b"mp4v")
        assert len(cv2_decode(path, False)) == len(planes), name
        digests[name] = {
            "options": options, "fourcc": fourcc.decode() if fourcc else "mp4v",
            "frames": len(planes), "height": int(planes[0][0].shape[0]),
            "width": int(planes[0][0].shape[1]), "reference": "libavcodec",
            "yuv_sha256": [hashlib.sha256(b"".join(p.tobytes() for p in f)).hexdigest()
                           for f in planes]}
    tmp = os.path.join(MPEG4_DIR, "content_720p.avi")
    mpeg4_writer.to_avi(mpeg4_writer.content_720p(), tmp, b"XVID")
    assert not cv2_errors(tmp)
    ys = cv2_decode(tmp, False)
    os.remove(tmp)
    spec = mpeg4_writer.CONTENT_720P
    assert len(ys) == spec["frames"]
    digests["content_720p"] = {**spec, "fourcc": "XVID", "height": 720, "width": 1280,
                               "y_sha256": [hashlib.sha256(y.tobytes()).hexdigest() for y in ys]}
    with open(os.path.join(MPEG4_DIR, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


def conceal_main():
    """``conceal_sha256.json``: the frame count and Y sha256 per frame of
    cv2's bundled FFmpeg decoding each damaged 720p clip of
    ``conceal_clips.py`` on one thread (``libavformat_planes``)."""
    import tempfile

    sys.path.insert(0, HERE)
    import conceal_clips

    digests = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, build in conceal_clips.CLIPS.items():
            path = os.path.join(tmp, name)
            hit = build(path)
            planes = libavformat_planes(path)
            digests[name] = {"frames": len(planes), "damaged": hit,
                             "y_sha256": [hashlib.sha256(np.ascontiguousarray(p[0]).tobytes())
                                          .hexdigest() for p in planes]}
    with open(os.path.join(HERE, "conceal_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)


def main():
    if sys.argv[1:] == ["conceal"]:
        return conceal_main()
    if sys.argv[1:] == ["mpeg4"]:
        mpeg4_main()
        return
    if sys.argv[1:] == ["rotated"]:
        rotated_main()
        return
    if sys.argv[1:] == ["h264"]:
        h264_main()
        return
    if sys.argv[1:] == ["hevc"]:
        hevc_main()
        return
    if sys.argv[1:] == ["avi", "swscale"]:
        swscale_main()
        return
    if sys.argv[1:] == ["avi", "clips"]:
        with open(os.path.join(AVI_DIR, "sha256.json")) as f:
            clip_digests(json.load(f))
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
