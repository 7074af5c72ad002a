"""ctypes binding of ``h264_writer.cpp``: legal H.264 I/P/B streams from a
seed, for the tests of the port's decoder (``adas_tpu_torch/render/h264.py``).
Built with the port's ``build_library`` into ``adas_tpu_torch/_build/``.

``exercise(**options)`` -> an Annex B stream of random legal syntax (B
pictures with ``bframes``);
``content(frames, n_p, pan, bframes=0)`` -> I_PCM pictures of the given
I420 frames, then ``n_p`` P (or B and P) pictures panning ``pan`` quarter
samples a picture;
``content_720p()`` / ``content_720p_b()`` -> the 720p content clips of
the fixtures (``h264/sha256.json`` holds cv2's Y digests of their decode);
``to_mp4(stream, path, fourcc)`` -> the stream as an ``avc1`` / ``avc3``
MP4 (``ctts`` and ``elst`` for B pictures).  Needs no cv2.
"""
import ctypes
import os
import threading

import numpy as np

from adas_tpu_torch.native.gxx import build_library
from adas_tpu_torch.render import h264

HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_lib = None

#: the exerciser's options and defaults, in the library's order (``Opt``)
OPTIONS = {
    "width": 64, "height": 48, "frames": 4, "seed": 0, "cabac": 0, "profile": 100,
    "t8x8": 1, "scaling": 0, "weighted": 0, "slices": 1, "refs": 1, "ref_mods": 0, "mmco": 0,
    "long_term": 0, "poc_type": 0, "deblock": 0, "cip": 0, "nonref": 0, "pcm": 2,
    "intra_in_p": 10, "qp_min": 16, "qp_max": 36, "idr_every": 0, "vui": 0, "big_levels": 0,
    "skip": 20, "mb_types": 0, "log2_poc_lsb": 0, "bframes": 0, "pyramid": 0, "direct": 2,
    "bipred": 0, "b_types": 0, "direct_4x4": 0,
}


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(os.path.join(HERE, "h264_writer.cpp"),
                                                "h264_writer", deps=(h264.SRC, h264.ER_H)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                for name, args, res in (
                        ("h264w_new", [], p), ("h264w_free", [p], None),
                        ("h264w_error", [p], ctypes.c_char_p),
                        ("h264w_exercise", [p, p, i], i),
                        ("h264w_content", [p, p, i, i, i, i, i, i, i, i, i], i),
                        ("h264w_size", [p], l), ("h264w_copy", [p, p], None)):
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def _run(call) -> bytes:
    lib = _native()
    w = lib.h264w_new()
    try:
        if call(lib, w):
            raise RuntimeError(lib.h264w_error(w).decode())
        out = np.empty(lib.h264w_size(w), np.uint8)
        lib.h264w_copy(w, out.ctypes.data)
        return out.tobytes()
    finally:
        lib.h264w_free(w)


def exercise(**options) -> bytes:
    """An Annex B stream of random legal syntax; ``options`` override
    ``OPTIONS``."""
    unknown = set(options) - set(OPTIONS)
    if unknown:
        raise TypeError(f"unknown exerciser options {sorted(unknown)}")
    opts = np.array([options.get(k, v) for k, v in OPTIONS.items()], np.int32)
    return _run(lambda lib, w: lib.h264w_exercise(w, opts.ctypes.data, len(opts)))


def content(frames, n_p: int = 0, pan=(0, 0), cabac: bool = True, bframes: int = 0,
            slice_rows: int = 0) -> bytes:
    """I_PCM pictures of ``frames`` ((N, H*3/2, W) I420 planes, or one
    frame), then ``n_p`` P pictures of P_L0_16x16 / P_Skip panning ``pan``
    = (x, y) quarter samples a picture, no residual; deblocking on.  With
    ``bframes`` (one frame), the ``n_p`` pictures come as groups of
    ``bframes`` B pictures (a pyramid of reference B pictures; B_Bi_16x16,
    B_Direct_16x16 and B_Skip, spatial and temporal direct in turn) before
    each P picture.  ``slice_rows``: a slice every that many macroblock
    rows (0: one slice a picture)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim == 2:
        frames = frames[None]
    n, h3, w = frames.shape
    return _run(lambda lib, wr: lib.h264w_content(wr, frames.ctypes.data, n, w, h3 * 2 // 3, n_p,
                                                  int(pan[0]), int(pan[1]), int(cabac),
                                                  int(bframes), int(slice_rows)))


#: the 720p content clip: frames (an IDR, then P pictures) and the pan in
#: quarter samples a picture
CONTENT_720P = {"frames": 24, "pan": (5, 2), "cabac": True}


#: the 720p B clip: the same pan in groups of three B pictures (a pyramid)
#: before each P picture
CONTENT_720P_B = {"frames": 24, "pan": (5, 2), "cabac": True, "bframes": 3}


def _frame_720p():
    from adas_tpu_torch.ops.preprocess import bgr_to_i420
    from adas_tpu_torch.render.image import imread

    return bgr_to_i420(imread(os.path.join(os.path.dirname(HERE), "images", "frame_720p.png")))


def content_720p() -> bytes:
    """The 720p content clip: an I_PCM IDR of
    ``tests/data/images/frame_720p.png`` (read by the port), then P
    pictures panning ``CONTENT_720P["pan"]``; deterministic."""
    return content(_frame_720p(), n_p=CONTENT_720P["frames"] - 1, pan=CONTENT_720P["pan"],
                   cabac=CONTENT_720P["cabac"])


def content_720p_b() -> bytes:
    """The 720p B clip: the I_PCM IDR of ``content_720p``, then the pan as
    IBBBP with a B pyramid (``CONTENT_720P_B``); deterministic."""
    spec = CONTENT_720P_B
    return content(_frame_720p(), n_p=spec["frames"] - 1, pan=spec["pan"], cabac=spec["cabac"],
                   bframes=spec["bframes"])


def avcc(sps: bytes, pps: bytes, length_size: int = 4, in_band: bool = False) -> bytes:
    """An AVCDecoderConfigurationRecord; without the parameter sets when
    they travel in band (``avc3``)."""
    out = bytes([1, sps[1], sps[2], sps[3], 0xFC | (length_size - 1)])
    if in_band:
        return out + bytes([0xE0, 0])
    return (out + bytes([0xE1]) + len(sps).to_bytes(2, "big") + sps
            + bytes([1]) + len(pps).to_bytes(2, "big") + pps)


def composition_offsets(aus) -> list:
    """Each access unit's composition offset in frames, as FFmpeg's muxer
    writes ``ctts`` for B pictures: the display position (POC order within
    each IDR period) less the decoding position, plus the reorder depth so
    that none is negative; None for a stream without B slices."""
    d = h264.Decoder(None)
    pocs, periods = [], []
    for au in aus:
        if any(n[0] & 0x1F == 5 for n in au):
            periods.append(len(periods) and periods[-1] + 1)
        else:
            periods.append(periods[-1] if periods else 0)
        d.decode(h264.annexb(au))
        pocs.append(d.last_poc)
    stats = d.stats()
    d.close()
    if not stats["b_slices"]:
        return None
    if stats["mmco5"]:
        raise ValueError("composition offsets of a stream with MMCO 5 (POCs restart)")
    order = sorted(range(len(aus)), key=lambda i: (periods[i], pocs[i]))
    disp = [0] * len(aus)
    for rank, i in enumerate(order):
        disp[i] = rank
    depth = max((i - disp[i] for i in range(len(aus))), default=0)
    return None if not depth else [disp[i] - i + depth for i in range(len(aus))]


def to_mp4(stream: bytes, path: str, fourcc: bytes = b"avc1", length_size: int = 4,
           fps: float = 30.0, moov_first: bool = False) -> int:
    """Writes an Annex B stream as one H.264 track of an MP4, an access unit
    a sample (NAL units ``length_size``-prefixed); ``avc1`` carries the
    SPS and PPS in its ``avcC``, ``avc3`` in band.  A stream with B
    pictures gets ``ctts`` and an ``edts``/``elst`` as FFmpeg's muxer
    writes them; the ``moov`` before the ``mdat`` with ``moov_first``.
    Returns the samples."""
    import struct

    from adas_tpu_torch.render import mp4

    nals = h264.nal_units(stream)
    sps = next(n for n in nals if n[0] & 0x1F == 7)
    pps = next(n for n in nals if n[0] & 0x1F == 8)
    in_band = fourcc == b"avc3"
    samples, keys = [], []
    aus = list(h264.access_units(nals))
    cts = composition_offsets(aus)
    for au in aus:
        body = b"".join(len(n).to_bytes(length_size, "big") + n for n in au
                        if in_band or n[0] & 0x1F not in (7, 8))
        if any(n[0] & 0x1F == 5 for n in au):
            keys.append(len(samples) + 1)
        samples.append(body)
    timescale, delta = mp4.rate(fps)
    if cts is not None:
        cts = [c * delta for c in cts]
    width, height = 16, 16  # the sample entry's; the decoder reads the SPS
    entry = mp4.visual_sample_entry(fourcc, width, height,
                                    mp4.box(b"avcC", avcc(sps, pps, length_size, in_band)))
    mdat = b"".join(samples)

    def moov_at(base):
        offsets, pos = [], base
        for i, s in enumerate(samples):
            if i % mp4.SAMPLES_PER_CHUNK == 0:
                offsets.append(pos)
            pos += len(s)
        return mp4.build_moov(width, height, b"", timescale, delta, [len(s) for s in samples],
                              keys, offsets, mp4.SAMPLES_PER_CHUNK, entry=entry, cts=cts)

    head = struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat))
    if moov_first:  # as a recorder that writes its index ahead: a cut file keeps it
        data = mp4.FTYP + moov_at(len(mp4.FTYP) + len(moov_at(0)) + 16) + head + mdat
    else:
        data = mp4.FTYP + head + mdat + moov_at(len(mp4.FTYP) + 16)
    with open(path, "wb") as f:
        f.write(data)
    return len(samples)
