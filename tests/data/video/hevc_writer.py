"""ctypes binding of ``hevc_writer.cpp``: legal H.265 I/P streams from a
seed, for the tests of the port's decoder (``adas_tpu_torch/render/hevc.py``).
Built with the port's ``build_library`` into ``adas_tpu_torch/_build/``.

``exercise(**options)`` -> an Annex B stream of random legal syntax;
``content(frames, n_p, pan)`` -> PCM pictures of the given I420 frames,
then ``n_p`` P pictures panning ``pan`` quarter samples a picture, each
coding unit a merge or an AMVP prediction;
``content_720p()`` -> the 720p content clip of the fixtures
(``hevc/sha256.json`` holds cv2's digests of its decode);
``to_mp4(stream, path, fourcc)`` -> the stream as an ``hvc1`` / ``hev1``
MP4; ``to_avi(stream, path, fourcc)`` -> as an AVI.  Needs no cv2.
"""
import ctypes
import os
import struct
import threading

import numpy as np

from adas_tpu_torch.native.gxx import build_library
from adas_tpu_torch.render import hevc

HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_lib = None

#: the exerciser's options and defaults, in the library's order (``Opt``)
OPTIONS = {
    "width": 64, "height": 48, "frames": 4, "seed": 0, "ctb": 16, "min_cb": 8, "amp": 0,
    "tu_depth": 1, "max_tb": 4, "intra_in_p": 10, "skip": 20, "pcm": 0, "pcm_bits": 8,
    "pcm_lf": 0, "tskip": 0, "sign_hiding": 0, "qp_delta": 0, "chroma_qp": 0, "scaling": 0,
    "cip": 0, "strong": 0, "tmvp": 0, "refs": 1, "merge_level": 0, "max_merge": 5,
    "deblock": 0, "sao": 0, "wpp": 0, "slices": 1, "across": 1, "cabac_init": 0, "qp_min": 22,
    "qp_max": 36, "idr_every": 0, "cra": 0, "reorder": 0, "output_flag": 0, "conf_win": 0,
    "sps_rps": 0, "list_mod": 0, "vui": 0, "log2_poc_lsb": 0, "big_levels": 0, "trail_start": 0,
}


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(os.path.join(HERE, "hevc_writer.cpp"),
                                                "hevc_writer", deps=(hevc.SRC,)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                for name, args, res in (
                        ("hevcw_new", [], p), ("hevcw_free", [p], None),
                        ("hevcw_error", [p], ctypes.c_char_p),
                        ("hevcw_exercise", [p, p, i], i),
                        ("hevcw_content", [p, p, i, i, i, i, i, i, i], i),
                        ("hevcw_refused", [p, i], i),
                        ("hevcw_size", [p], l), ("hevcw_copy", [p, p], None)):
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def _run(call) -> bytes:
    lib = _native()
    w = lib.hevcw_new()
    try:
        if call(lib, w):
            raise RuntimeError(lib.hevcw_error(w).decode())
        out = np.empty(lib.hevcw_size(w), np.uint8)
        lib.hevcw_copy(w, out.ctypes.data)
        return out.tobytes()
    finally:
        lib.hevcw_free(w)


def exercise(**options) -> bytes:
    """An Annex B stream of random legal syntax; ``options`` override
    ``OPTIONS``."""
    unknown = set(options) - set(OPTIONS)
    if unknown:
        raise TypeError(f"unknown exerciser options {sorted(unknown)}")
    opts = np.array([options.get(k, v) for k, v in OPTIONS.items()], np.int32)
    return _run(lambda lib, w: lib.hevcw_exercise(w, opts.ctypes.data, len(opts)))


def content(frames, n_p: int = 0, pan=(0, 0), wpp: bool = True) -> bytes:
    """PCM pictures of ``frames`` ((N, H*3/2, W) I420 planes, or one
    frame; the first an IDR picture, the others CRA pictures), then ``n_p``
    P pictures panning ``pan`` = (x, y) quarter samples a picture, each
    coding unit a skip (merge) or an AMVP prediction without residual;
    64x64 CTBs, deblocking on, TMVP on, WPP on unless ``wpp`` is false."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim == 2:
        frames = frames[None]
    n, h3, w = frames.shape
    return _run(lambda lib, wr: lib.hevcw_content(wr, frames.ctypes.data, n, w, h3 * 2 // 3, n_p,
                                                  int(pan[0]), int(pan[1]), int(wpp)))


#: the tools the decoder refuses, by the kind ``refused(kind)`` takes
REFUSED = {"B slices": 1, "long-term reference pictures": 2, "weighted prediction": 3,
           "tiles": 4, "dependent slice segments": 5, "cu_transquant_bypass": 6,
           "bit depth 10/10": 7, "chroma_format_idc 2": 8, "layers above 0": 9}


def refused(kind: int) -> bytes:
    """Parameter sets and one slice header that carry a tool the decoder
    refuses (``REFUSED``)."""
    return _run(lambda lib, w: lib.hevcw_refused(w, int(kind)))


#: the 720p content clip: frames (a PCM IDR picture, then P pictures) and
#: the pan in quarter samples a picture
CONTENT_720P = {"frames": 60, "pan": (5, 2)}


def frame_720p():
    from adas_tpu_torch.ops.preprocess import bgr_to_i420
    from adas_tpu_torch.render.image import imread

    return bgr_to_i420(imread(os.path.join(os.path.dirname(HERE), "images", "frame_720p.png")))


def content_720p() -> bytes:
    """The 720p content clip: a PCM IDR picture of
    ``tests/data/images/frame_720p.png`` (read by the port), then P
    pictures panning ``CONTENT_720P["pan"]``; deterministic."""
    return content(frame_720p(), n_p=CONTENT_720P["frames"] - 1, pan=CONTENT_720P["pan"])


def hvcc(nals, length_size: int = 4, in_band: bool = False) -> bytes:
    """An HEVCDecoderConfigurationRecord of the stream's VPS, SPS and PPS;
    without them when they travel in band (``hev1``)."""
    head = bytes([1, 0x01, 0x60, 0, 0, 0, 0x90, 0, 0, 0, 0, 0, 93, 0xF0, 0x00, 0xFC, 0xFD,
                  0xF8, 0xF8, 0, 0, 0x0F | ((length_size - 1) & 3)])
    head = head[:21] + bytes([0x0C | ((length_size - 1) & 3)])
    if in_band:
        return head + bytes([0])
    arrays = b""
    count = 0
    for kind in (32, 33, 34):
        units = [n for n in nals if hevc.nal_type(n) == kind]
        if units:
            count += 1
            arrays += bytes([0x80 | kind]) + struct.pack(">H", len(units))
            arrays += b"".join(struct.pack(">H", len(n)) + n for n in units)
    return head + bytes([count]) + arrays


def to_mp4(stream: bytes, path: str, fourcc: bytes = b"hvc1", length_size: int = 4,
           fps: float = 30.0) -> int:
    """Writes an Annex B stream as one H.265 track of an MP4, an access unit
    a sample (NAL units ``length_size``-prefixed); ``hvc1`` carries the
    VPS, SPS and PPS in its ``hvcC``, ``hev1`` in band.  Returns the
    samples."""
    from adas_tpu_torch.render import mp4

    nals = hevc.nal_units(stream)
    in_band = fourcc == b"hev1"
    samples, keys = [], []
    for au in hevc.access_units(nals):
        body = b"".join(len(n).to_bytes(length_size, "big") + n for n in au
                        if in_band or hevc.nal_type(n) not in (32, 33, 34))
        if any(16 <= hevc.nal_type(n) <= 21 for n in au):
            keys.append(len(samples) + 1)
        samples.append(body)
    timescale, delta = mp4.rate(fps)
    width, height = 16, 16  # the sample entry's; the decoder reads the SPS
    entry = mp4.visual_sample_entry(fourcc, width, height,
                                    mp4.box(b"hvcC", hvcc(nals, length_size, in_band)))
    mdat = b"".join(samples)
    offsets, pos = [], len(mp4.FTYP) + 16
    for i, s in enumerate(samples):
        if i % mp4.SAMPLES_PER_CHUNK == 0:
            offsets.append(pos)
        pos += len(s)
    moov = mp4.build_moov(width, height, b"", timescale, delta, [len(s) for s in samples], keys,
                          offsets, mp4.SAMPLES_PER_CHUNK, entry=entry)
    with open(path, "wb") as f:
        f.write(mp4.FTYP + struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat)) + mdat + moov)
    return len(samples)


def to_avi(stream: bytes, path: str, fourcc: bytes = b"HEVC", width: int = 16,
           height: int = 16) -> int:
    """Writes an Annex B stream into an AVI, an access unit a chunk (the
    parameter sets with the first).  Returns the chunks."""
    from adas_tpu_torch.render import avi

    aus = list(hevc.access_units(hevc.nal_units(stream)))
    with avi.Muxer(path, width, height, fourcc) as m:
        for au in aus:
            m.add(hevc.annexb(au), any(16 <= hevc.nal_type(n) <= 21 for n in au))
    return len(aus)
