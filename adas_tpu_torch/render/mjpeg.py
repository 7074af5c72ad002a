"""ctypes binding of ``native/mjpeg.cpp``: the Motion JPEG decoder of the
demo's video input (``render/video.py``), decoding as FFmpeg's ``mjpeg``
decoder decodes for ``cv2.VideoCapture`` (not as ``render/image.py``'s
libjpeg-like still-image decoder, which rounds otherwise).

``Decoder(container_height)`` decodes a stream's frames one at a time;
Huffman and quantisation tables persist from frame to frame, starting from
the standard tables of Annex K, as in FFmpeg.  ``decode(frame)`` gives the
frame's planes as decoded, full range and not upsampled: one (height,
width) array for gray, else a tuple (Y, Cb, Cr) of FFmpeg's ``yuvj444p``,
``yuvj422p``, ``yuvj440p``, ``yuvj420p`` or ``yuvj411p`` sizes
(``format`` names which); ``bgr()`` is the last frame as (height, width,
3) uint8 BGR, converted with JFIF's full-range BT.601 matrix and nearest
chroma.  ``stats()`` counts frames, scans, restart markers and scans that
used a standard table (``STATS``).

Progressive, lossless, hierarchical, arithmetic-coded, JPEG-LS and
12-bit frames, RGB and CMYK frames, other sampling factors, interlaced
two-field frames (under 3/4 of ``container_height``, FFmpeg's test),
corrupt or truncated data and pictures of more than ``MAX_PIXELS`` raise a
``ValueError`` carrying the library's message, which names the tool.  The
library is built with g++ into ``adas_tpu_torch/_build/libmjpeg.so`` on
first use (``native/gxx.py``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Tuple, Union

import numpy as np

from ..native.gxx import build_library
from .mpeg4 import IDCT_H

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "mjpeg.cpp")
_LOCK = threading.Lock()
_lib = None

#: the largest picture, in pixels (``kMaxPixels`` of the library)
MAX_PIXELS = 1 << 25
#: the library's formats (``Format`` in mjpeg.cpp) and FFmpeg's names
FORMATS = ("gray", "yuvj420p", "yuvj422p", "yuvj440p", "yuvj444p", "yuvj411p")
#: each format's chroma subsampling: (log2 across, log2 down)
CHROMA_SHIFT = {"yuvj420p": (1, 1), "yuvj422p": (1, 0), "yuvj440p": (0, 1),
                "yuvj444p": (0, 0), "yuvj411p": (2, 0)}
#: the decoder's counters, in the library's order
STATS = ("frames", "scans", "restart_markers", "standard_table_scans")


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(_SRC, "mjpeg", deps=(IDCT_H,)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)
                sigs = {
                    "mjpeg_decoder_new": ([i], p), "mjpeg_decoder_free": ([p], None),
                    "mjpeg_decoder_error": ([p], ctypes.c_char_p),
                    "mjpeg_decode": ([p, p, l, ip, ip, ip, lp], i),
                    "mjpeg_planes": ([p, p], i), "mjpeg_bgr": ([p, p], i),
                    "mjpeg_stats": ([p, p, i], i),
                }
                for name, (args, res) in sigs.items():
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def chroma_size(fmt: str, width: int, height: int) -> Tuple[int, int]:
    """(width, height) of a format's Cb and Cr planes (FFmpeg's rounding up)."""
    sw, sh = CHROMA_SHIFT[fmt]
    return -(-width >> sw), -(-height >> sh)


class Decoder:
    """A Motion JPEG stream's decoder; ``container_height`` (0 for none) is
    the height the container gives, against which a two-field frame shows."""

    def __init__(self, container_height: int = 0):
        lib = _native()
        self._lib, self._d = lib, lib.mjpeg_decoder_new(int(container_height))
        if not self._d:
            raise MemoryError("mjpeg decoder")
        self.width = self.height = 0
        self.format = ""

    def decode(self, frame: bytes) -> Union[np.ndarray, Tuple[np.ndarray, ...]]:
        """One frame -> its planes: Y alone for gray, else (Y, Cb, Cr)."""
        if not self._d:
            raise ValueError("the Motion JPEG decoder is closed")
        w, h, f, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        if self._lib.mjpeg_decode(self._d, frame, len(frame), ctypes.byref(w), ctypes.byref(h),
                                  ctypes.byref(f), ctypes.byref(n)) < 0:
            self.width = self.height = 0
            raise ValueError(self._lib.mjpeg_decoder_error(self._d).decode())
        self.width, self.height, self.format = w.value, h.value, FORMATS[f.value]
        out = np.empty(n.value, np.uint8)
        self._lib.mjpeg_planes(self._d, out.ctypes.data)
        y = out[:self.width * self.height].reshape(self.height, self.width)
        if self.format == "gray":
            return y
        cw, ch = chroma_size(self.format, self.width, self.height)
        c = out[self.width * self.height:].reshape(2, ch, cw)
        return y, c[0], c[1]

    def bgr(self) -> np.ndarray:
        """The last decoded frame as (height, width, 3) BGR uint8."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if not self._d or self._lib.mjpeg_bgr(self._d, out.ctypes.data) < 0:
            raise ValueError("no Motion JPEG frame: the last decode failed, or the decoder is "
                             "closed")
        return out

    def stats(self) -> Dict[str, int]:
        if not self._d:
            raise ValueError("the Motion JPEG decoder is closed")
        out = np.zeros(len(STATS), np.int64)
        self._lib.mjpeg_stats(self._d, out.ctypes.data, len(STATS))
        return dict(zip(STATS, out.tolist()))

    def close(self) -> None:
        if self._d:
            self._lib.mjpeg_decoder_free(self._d)
            self._d = None

    def __del__(self):
        self.close()
