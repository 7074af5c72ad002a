"""ctypes binding of ``mpeg4_writer.cpp``: legal MPEG-4 Part 2 Advanced
Simple streams from a seed, for the tests of the port's decoder
(``adas_tpu_torch/render/mpeg4.py``).  Built with the port's
``build_library`` into ``adas_tpu_torch/_build/``.

``exercise(**options)`` -> a ``Stream`` of random legal syntax (B-VOPs
with ``bframes``, ``four_mv``, ``qpel``, ``mpeg_quant``, video
``packets``, ``user`` data of Lavc / an XviD build / a DivX build, packed
when it has B-VOPs);
``content(frames, pan, **options)`` -> an intra VOP of the first frame,
then the others coded as a quarter-sample pan with 4MV and MPEG
quantisation;
``content_720p()`` -> the 720p content clip of the fixtures
(``mpeg4/sha256.json`` holds cv2's Y digests of its decode);
``to_avi(stream, path, fourcc)`` / ``to_mp4(stream, path)`` -> the stream
muxed by the port's muxers (an MP4 gets ``ctts`` for B-VOPs).  Needs no
cv2.
"""
import ctypes
import os
import struct
import threading
from typing import List, NamedTuple

import numpy as np

from adas_tpu_torch.native.gxx import build_library
from adas_tpu_torch.render import avi, mp4, mpeg4

HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_lib = None

#: the exerciser's options and defaults, in the library's order (``Opt``);
#: ``user``: 0 Lavc (``lavc_major``; 56: the builds whose emulated chroma
#: edge FFmpeg shortens), 1 XviD (``build``), 2 DivX (``divx_version``,
#: ``build``), 3 no user data; ``xvid_ilace``: field DCT flags without a
#: cbp, as an ``XVIX`` AVI's XviD wrote them
OPTIONS = {
    "width": 64, "height": 48, "frames": 8, "seed": 0, "bframes": 0, "four_mv": 0, "qpel": 0,
    "mpeg_quant": 0, "packets": 0, "hec": 0, "user": 0, "build": 64, "divx_version": 503,
    "nvop": 0, "intra": 10, "skip": 20, "dquant": 15, "q_min": 2, "q_max": 12, "fcode": 0,
    "resolution": 30, "increment": 1, "control": 1, "outside": 10, "ac_pred": 50, "dc_thr": -1,
    "big_levels": 5, "interlaced": 0, "field_mv": 30, "field_dct": 50, "lavc_major": 61,
    "xvid_ilace": 0,
}
LAVC, XVID, DIVX, NO_USER_DATA = range(4)
#: XviD's preset of tools, as its encoder combines them
XVID_PRESET = {"bframes": 2, "four_mv": 30, "qpel": 1, "mpeg_quant": 1}


class Stream(NamedTuple):
    """A written stream: the VOS/VO/VOL/user data, the samples in decoding
    order (each I-VOP's with those headers in band), whether each is key,
    its display position and VOP type (3: an N-VOP)."""
    header: bytes
    samples: List[bytes]
    keys: List[bool]
    display: List[int]
    types: List[int]


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(
                    os.path.join(HERE, "mpeg4_writer.cpp"), "mpeg4_writer",
                    deps=(mpeg4._SRC, mpeg4.IDCT_H, mpeg4.XVID_IDCT_H, mpeg4.ER_H)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                for name, args, res in (
                        ("mpeg4w_new", [], p), ("mpeg4w_free", [p], None),
                        ("mpeg4w_error", [p], ctypes.c_char_p),
                        ("mpeg4w_exercise", [p, p, i], i),
                        ("mpeg4w_content", [p, p, i, p, i, i, i], i),
                        ("mpeg4w_count", [p], i), ("mpeg4w_header", [p, p], l),
                        ("mpeg4w_sample", [p, i, p, p], l)):
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def _options(options) -> np.ndarray:
    unknown = set(options) - set(OPTIONS)
    if unknown:
        raise TypeError(f"unknown writer options {sorted(unknown)}")
    return np.array([options.get(k, v) for k, v in OPTIONS.items()], np.int32)


def _run(call) -> Stream:
    lib = _native()
    w = lib.mpeg4w_new()
    try:
        if call(lib, w):
            raise RuntimeError(lib.mpeg4w_error(w).decode())
        header = np.empty(lib.mpeg4w_header(w, None), np.uint8)
        lib.mpeg4w_header(w, header.ctypes.data)
        samples, keys, display, types = [], [], [], []
        info = np.zeros(3, np.int32)
        for i in range(lib.mpeg4w_count(w)):
            out = np.empty(lib.mpeg4w_sample(w, i, None, info.ctypes.data), np.uint8)
            lib.mpeg4w_sample(w, i, out.ctypes.data, info.ctypes.data)
            samples.append(out.tobytes())
            keys.append(bool(info[0]))
            display.append(int(info[1]))
            types.append(int(info[2]))
        return Stream(header.tobytes(), samples, keys, display, types)
    finally:
        lib.mpeg4w_free(w)


def exercise(**options) -> Stream:
    """A stream of random legal syntax; ``options`` override ``OPTIONS``."""
    opts = _options(options)
    return _run(lambda lib, w: lib.mpeg4w_exercise(w, opts.ctypes.data, len(opts)))


def content(src: np.ndarray, pan=(0, 0), **options) -> Stream:
    """An intra VOP of ``src[0]`` ((N, H*3/2, W) I420 planes), then the
    display frames 1.. coded from ``src[t]`` as I(B..)P with 4MV and the
    pan's quarter-sample vectors (``pan`` a frame), MPEG-quantised; with
    ``packets``, a video packet every that many macroblock rows."""
    frames = np.ascontiguousarray(src, np.uint8)
    n, h3, w = frames.shape
    opts = _options({"qpel": 1, "mpeg_quant": 1, "user": XVID, **options,
                     "width": w, "height": h3 * 2 // 3})
    return _run(lambda lib, wr: lib.mpeg4w_content(wr, opts.ctypes.data, len(opts),
                                                   frames.ctypes.data, n, int(pan[0]),
                                                   int(pan[1])))


def pan_frames(image_i420: np.ndarray, n: int, pan) -> np.ndarray:
    """``n`` I420 frames of a camera panning over ``image_i420`` by ``pan``
    quarter samples a frame: each plane resampled bilinearly at the
    offset, clamped at the edges."""
    h = image_i420.shape[0] * 2 // 3
    w = image_i420.shape[1]
    planes = [image_i420[:h], image_i420[h:h + h // 4 * 1].reshape(h // 2, w // 2),
              image_i420[h + h // 4:].reshape(h // 2, w // 2)]
    out = []
    for t in range(n):
        frame = []
        for c, p in enumerate(planes):
            s = 1 if c == 0 else 2
            dx, dy = pan[0] * t / 4 / s, pan[1] * t / 4 / s
            ph, pw = p.shape
            y, x = np.mgrid[0:ph, 0:pw].astype(np.float64)
            xs, ys = np.clip(x + dx, 0, pw - 1), np.clip(y + dy, 0, ph - 1)
            x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
            x1, y1 = np.minimum(x0 + 1, pw - 1), np.minimum(y0 + 1, ph - 1)
            fx, fy = xs - x0, ys - y0
            v = (p[y0, x0] * (1 - fx) * (1 - fy) + p[y0, x1] * fx * (1 - fy)
                 + p[y1, x0] * (1 - fx) * fy + p[y1, x1] * fx * fy)
            frame.append(np.clip(np.rint(v), 0, 255).astype(np.uint8).ravel())
        out.append(np.concatenate(frame).reshape(h * 3 // 2, w))
    return np.stack(out)


#: the 720p content clip: display frames, the pan in quarter samples a
#: frame, B-VOPs before each P-VOP
CONTENT_720P = {"frames": 12, "pan": (5, 2), "bframes": 2}


def frame_720p() -> np.ndarray:
    from adas_tpu_torch.ops.preprocess import bgr_to_i420
    from adas_tpu_torch.render.image import imread

    return bgr_to_i420(imread(os.path.join(os.path.dirname(HERE), "images", "frame_720p.png")))


def content_720p() -> Stream:
    """The 720p content clip: an intra VOP of ``tests/data/images/
    frame_720p.png`` (read by the port), then the pan as IBBP with 4MV,
    quarter-sample vectors and MPEG quantisation, XviD's user data;
    deterministic."""
    spec = CONTENT_720P
    frames = pan_frames(frame_720p(), spec["frames"], spec["pan"])
    return content(frames, spec["pan"], frames=spec["frames"], bframes=spec["bframes"])


def to_avi(stream: Stream, path: str, fourcc: bytes = b"XVID", fps: float = 30.0) -> int:
    """The samples as one video stream of an AVI tagged ``fourcc``, in
    decoding order (the headers in band); returns the samples."""
    d = mpeg4.Decoder(stream.header)
    with avi.Muxer(path, d.width, d.height, fourcc, fps) as m:
        for s, k in zip(stream.samples, stream.keys):
            m.add(s, k)
    return len(stream.samples)


def to_mp4(stream: Stream, path: str, fps: float = 30.0, moov_first: bool = False) -> int:
    """The samples as an ``mp4v`` track (the headers in the ``esds``, none
    in band); ``ctts`` for B-VOPs as FFmpeg's muxer writes it; the ``moov``
    after the ``mdat``, or before it with ``moov_first``."""
    samples = [s[len(stream.header):] if k else s for s, k in zip(stream.samples, stream.keys)]
    timescale, delta = mp4.rate(fps)
    n = len(samples)
    depth = max((i - d for i, d in enumerate(stream.display)), default=0)
    cts = None if not depth else [(d - i + depth) * delta for i, d in enumerate(stream.display)]
    keys = [i + 1 for i, k in enumerate(stream.keys) if k]
    mdat = b"".join(samples)
    d = mpeg4.Decoder(stream.header)

    def moov_at(base):
        offsets, pos = [], base
        for i, s in enumerate(samples):
            if i % mp4.SAMPLES_PER_CHUNK == 0:
                offsets.append(pos)
            pos += len(s)
        return mp4.build_moov(d.width, d.height, stream.header, timescale, delta,
                              [len(s) for s in samples], keys, offsets, mp4.SAMPLES_PER_CHUNK,
                              cts=cts)

    _write_mp4(path, mdat, moov_at, moov_first)
    return n


def _write_mp4(path, mdat, moov_at, moov_first):
    """ftyp, then mdat and moov, or moov first (as a recorder that writes
    its index ahead, so that a cut file keeps it); ``moov_at(base)`` builds
    the moov for samples from ``base``."""
    head = struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat))
    if moov_first:
        moov = moov_at(len(mp4.FTYP) + len(moov_at(0)) + 16)
        data = mp4.FTYP + moov + head + mdat
    else:
        data = mp4.FTYP + head + mdat + moov_at(len(mp4.FTYP) + 16)
    with open(path, "wb") as f:
        f.write(data)
