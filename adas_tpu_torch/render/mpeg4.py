"""ctypes binding of ``native/mpeg4.cpp``: the MPEG-4 Part 2 decoder and
encoder of the ``mp4v`` video the demo reads and writes
(``render/video.py``).

``Decoder(config, codec_tag)`` takes the container's DecoderSpecificInfo
(the VOS / VO / VOL headers and any user data) and, from an AVI, its
fourcc; ``decode(sample)`` gives the frames the sample lets out, in
FFmpeg's order and delay (packed I420 planes: Y of ``height`` x ``width``,
then U and V of ``(height + 1) // 2`` x ``(width + 1) // 2``, each a flat
uint8 array), ``flush()`` the rest at the end; ``last_type`` is the VOP
type of the last frame let out; ``stats()`` counts the tools the stream
used.  The decoder reads Simple and Advanced Simple streams: I-, P- and
B-VOPs (direct, interpolated, forward and backward, DivX's packed
B-VOPs), N-VOPs, 4MV, half- and quarter-sample vectors, H.263 and MPEG
quantisation (default and loaded matrices), resync markers (video
packets), and picks the IDCT (simple, or XviD's for XviD streams) and
bug workarounds from the user data and fourcc as libavcodec does.
``Encoder(width, height, ...)`` gives its ``header()`` and
``encode(planes)`` -> (VOP bytes, key, reconstructed planes): the planes a
decoder of the stream gives, to the bit.

A VOP's damaged, cut or lost video packets are decoded and concealed as
FFmpeg conceals them (``native/error_resilience.h``); ``stats()`` counts
``concealed_mbs``, ``damaged_vops``, ``damaged_packets``, ``resyncs``
and the microseconds spent concealing (``conceal_us``).  Data
partitioning, sprites and GMC, OBMC, the short video header and the
other tools outside Advanced Simple, headers FFmpeg refuses, and
pictures of more than ``MAX_PIXELS`` raise a ``ValueError`` carrying the
library's message, which names the tool.  The
library is built with g++ into ``adas_tpu_torch/_build/libmpeg4.so`` on
first use (``native/gxx.py``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Tuple

import numpy as np

from ..native.gxx import build_library
from .h264 import Refused

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE, "mpeg4.cpp")
#: the IDCT mpeg4.cpp shares with mjpeg.cpp
IDCT_H = os.path.join(_NATIVE, "simple_idct.h")
#: the IDCT of streams an XviD build wrote
XVID_IDCT_H = os.path.join(_NATIVE, "xvid_idct.h")
#: FFmpeg's error concealment, shared with h264.cpp
ER_H = os.path.join(_NATIVE, "error_resilience.h")
_LOCK = threading.Lock()
_lib = None

#: the largest picture, in pixels (``kMaxPixels`` of the library)
MAX_PIXELS = 1 << 25
#: the encoder's vop_quant (Y PSNR >= 38 dB on smooth content), its I-VOP
#: interval (cv2's writer's) and f_code (vectors up to 32 px a frame)
QUANT, GOP, FCODE = 4, 12, 2
#: the decoder's counters, in the library's order
STATS = ("i_vops", "p_vops", "p_rounding_0", "p_rounding_1", "intra_mbs_in_i", "intra_mbs_in_p",
         "inter_mbs", "not_coded_mbs", "ac_pred_on", "ac_pred_off", "escape_1", "escape_2",
         "escape_3", "max_fcode", "mv_outside", "dquant_mbs", "b_vops", "n_vops", "inter4v_mbs",
         "direct_mbs", "direct_8x8_mbs", "forward_mbs", "backward_mbs", "interpolate_mbs",
         "b_skipped_mbs", "dbquant_mbs", "max_bcode", "qpel_vops", "mpeg_quant_vops",
         "custom_matrices", "video_packets", "hec_packets", "packed_b_vops", "xvid_idct_vops",
         "interlaced_vops", "alt_scan_vops", "field_mbs", "field_dct_mbs", "field_direct_mbs",
         "concealed_mbs", "damaged_vops", "damaged_packets", "resyncs", "conceal_us",
         "time_bits_guessed", "damaged_headers")
#: the VOP types of ``Decoder.last_type``
TYPES = "IPB"


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(_SRC, "mpeg4", deps=(IDCT_H, XVID_IDCT_H, ER_H)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                ip = ctypes.POINTER(ctypes.c_int)
                sigs = {
                    "mpeg4_decoder_new": ([], p), "mpeg4_decoder_free": ([p], None),
                    "mpeg4_decoder_error": ([p], ctypes.c_char_p),
                    "mpeg4_decoder_tag": ([p, ctypes.c_uint], None),
                    "mpeg4_decoder_config": ([p, p, l, ip, ip], i),
                    "mpeg4_decode": ([p, p, l, ip, ip], i),
                    "mpeg4_decoder_flush": ([p], i), "mpeg4_decoder_refused": ([p], i),
                    "mpeg4_decoder_output": ([p, p, l, ip], i),
                    "mpeg4_decoder_stats": ([p, p, i], i),
                    "mpeg4_encoder_new": ([], p), "mpeg4_encoder_free": ([p], None),
                    "mpeg4_encoder_error": ([p], ctypes.c_char_p),
                    "mpeg4_encoder_open": ([p, i, i, i, i, i, i, i], i),
                    "mpeg4_encoder_header": ([p, p], i),
                    "mpeg4_encode": ([p, p, p, ip], l),
                    "mpeg4_encoder_output": ([p, p], None),
                }
                for name, (args, res) in sigs.items():
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def plane_bytes(width: int, height: int) -> int:
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


class Decoder:
    """An ``mp4v`` stream's decoder, configured by its VOS / VOL headers
    (and any user data before them), in FFmpeg's order and delay: ``decode``
    gives the frames a sample lets out, ``flush`` the rest at the end.
    ``codec_tag`` is the container's fourcc (an AVI's ``XVID``, ``DIVX``,
    ...), from which FFmpeg, and the decoder with it, take the encoder when
    the user data does not name it."""

    def __init__(self, config: bytes, codec_tag: bytes = b""):
        lib = _native()
        self._lib, self._d = lib, lib.mpeg4_decoder_new()
        if not self._d:
            raise MemoryError("mpeg4 decoder")
        if codec_tag:
            lib.mpeg4_decoder_tag(self._d, int.from_bytes(codec_tag[:4].ljust(4, b"\0"),
                                                          "little"))
        w, h = ctypes.c_int(), ctypes.c_int()
        if lib.mpeg4_decoder_config(self._d, config, len(config), ctypes.byref(w),
                                    ctypes.byref(h)):
            self._raise()
        self.width, self.height = w.value, h.value
        #: the VOP type ("I", "P" or "B") of the last frame let out
        self.last_type = ""

    def _raise(self):
        msg = self._lib.mpeg4_decoder_error(self._d).decode()
        self.close()
        raise ValueError(msg)

    def _take(self, n: int) -> List[np.ndarray]:
        if n < 0:
            raise ValueError(self._lib.mpeg4_decoder_error(self._d).decode())
        frames = []
        t = ctypes.c_int()
        for _ in range(n):
            planes = np.empty(plane_bytes(self.width, self.height), np.uint8)
            if self._lib.mpeg4_decoder_output(self._d, planes.ctypes.data, planes.size,
                                              ctypes.byref(t)):
                raise ValueError(self._lib.mpeg4_decoder_error(self._d).decode())
            self.last_type = TYPES[t.value]
            frames.append(planes)
        return frames

    def decode(self, sample: bytes) -> List[np.ndarray]:
        """One sample -> the frames it lets out (packed I420 planes, each a
        new array): none for a VOP that is not coded or before the reorder
        delay is filled, one otherwise."""
        w, h = ctypes.c_int(), ctypes.c_int()
        frames = self._take(self._lib.mpeg4_decode(self._d, sample, len(sample), ctypes.byref(w),
                                                   ctypes.byref(h)))
        if self._lib.mpeg4_decoder_refused(self._d):
            raise Refused("corrupt MPEG-4 video: the VOP header is damaged (FFmpeg refuses the "
                          "packet, and cv2 stops reading there)")
        return frames

    def flush(self) -> List[np.ndarray]:
        """The end of the stream: the frames still held back."""
        return self._take(self._lib.mpeg4_decoder_flush(self._d))

    def stats(self) -> Dict[str, int]:
        out = np.zeros(len(STATS), np.int64)
        self._lib.mpeg4_decoder_stats(self._d, out.ctypes.data, len(STATS))
        return dict(zip(STATS, out.tolist()))

    def close(self) -> None:
        if self._d:
            self._lib.mpeg4_decoder_free(self._d)
            self._d = None

    def __del__(self):
        self.close()


class Encoder:
    """Writes an ``mp4v`` stream of even ``width`` x ``height`` frames at
    ``increment`` / ``resolution`` s per frame: an I-VOP every ``GOP``
    frames, P-VOPs between, at vop_quant ``QUANT``."""

    def __init__(self, width: int, height: int, resolution: int = 30, increment: int = 1):
        if width * height > MAX_PIXELS:
            raise ValueError(f"{width}x{height} is larger than {MAX_PIXELS} pixels")
        lib = _native()
        self._lib, self._e = lib, lib.mpeg4_encoder_new()
        if not self._e:
            raise MemoryError("mpeg4 encoder")
        if lib.mpeg4_encoder_open(self._e, width, height, QUANT, GOP, FCODE, resolution,
                                  increment):
            msg = lib.mpeg4_encoder_error(self._e).decode()
            self.close()
            raise ValueError(msg)
        self.width, self.height = width, height
        buf = np.zeros(64, np.uint8)
        self._header = buf[:lib.mpeg4_encoder_header(self._e, buf.ctypes.data)].tobytes()

    def header(self) -> bytes:
        """The VOS, VO and VOL headers (the container's DecoderSpecificInfo)."""
        return self._header

    def encode(self, planes: np.ndarray) -> Tuple[bytes, bool, np.ndarray]:
        """Packed I420 planes -> (the VOP, whether it is an I-VOP, the
        reconstructed planes)."""
        planes = np.ascontiguousarray(planes, np.uint8).reshape(-1)
        if planes.size != plane_bytes(self.width, self.height):
            raise ValueError(f"expected {plane_bytes(self.width, self.height)} bytes of I420 "
                             f"planes, got {planes.size}")
        recon = np.empty_like(planes)
        key = ctypes.c_int()
        n = self._lib.mpeg4_encode(self._e, planes.ctypes.data, recon.ctypes.data,
                                   ctypes.byref(key))
        if n < 0:
            raise ValueError(self._lib.mpeg4_encoder_error(self._e).decode())
        out = np.empty(n, np.uint8)
        self._lib.mpeg4_encoder_output(self._e, out.ctypes.data)
        return out.tobytes(), bool(key.value), recon

    def close(self) -> None:
        if self._e:
            self._lib.mpeg4_encoder_free(self._e)
            self._e = None

    def __del__(self):
        self.close()
