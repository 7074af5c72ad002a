"""ctypes wrapper for the port's stroke rasterizer (``draw.cpp``): lines,
polylines, circles and filled polygons in cv2's 16.16 fixed
point, cv2's 8-bit ``addWeighted`` and the host I420 -> BGR decode.

The library is built with g++ into ``adas_tpu_torch/_build/libdraw.so`` on
first use (or when the source is newer than the binary) and loaded with
ctypes.  A failed build raises: there is no fallback.  Every function
draws in place on a C-contiguous (H, W) or (H, W, C) uint8 image, C in
1, 3, 4; points are integer (x, y) pairs with ``shift`` fractional bits
(cv2's convention) and are clipped to the canvas by the rasterizer, so
any value an int64 holds after the shift is safe.  The cv2-named entry
points over these live in ``render/draw.py``.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from .gxx import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "draw.cpp")
_LOCK = threading.Lock()
_lib = None

# arrays go by address (``_ptr``): the wrappers below make them
# C-contiguous of the right dtype, and ndpointer's per-call checks would
# cost more than the drawing of a short label
_IMG = _I64 = _I32 = ctypes.c_void_p
_INT = ctypes.c_int


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _color(color: np.ndarray, nch: int) -> int:
    """Address of a colour of at least ``nch`` bytes."""
    c = np.ascontiguousarray(color, dtype=np.uint8)
    if c.size < nch:
        raise ValueError(f"a colour of {c.size} values for a {nch}-channel image")
    return _ptr(c)

_SIGNATURES = {
    # img, h, w, nch, pts, npts, ncontours, closed, color, thickness, line_type, shift
    "draw_polylines": [_IMG, _INT, _INT, _INT, _I64, _I32, _INT, _INT, _IMG, _INT, _INT, _INT],
    # img, h, w, nch, pts, n, color, line_type, shift
    "draw_fill_convex": [_IMG, _INT, _INT, _INT, _I64, _INT, _IMG, _INT, _INT],
    # img, h, w, nch, pts, npts, ncontours, color, line_type, shift, off_x, off_y
    "draw_fill_poly": [_IMG, _INT, _INT, _INT, _I64, _I32, _INT, _IMG, _INT, _INT, _INT, _INT],
    # img, h, w, nch, centers, radii, thicknesses, n, color, line_type, shift
    "draw_circles": [_IMG, _INT, _INT, _INT, _I64, _I32, _I32, _INT, _IMG, _INT, _INT],
    # img, h, w, nch, alpha, offs, gh, gw, gx, gy, n, color
    "blend_glyphs": [_IMG, _INT, _INT, _INT, _IMG, _I64, _I32, _I32, _I32, _I32, _INT, _IMG],
    # src, sh, sw, nch, dst, dh, dw, xo0, xo1, wx0, wx1, yo0, yo1, wy0, wy1
    "resize_linear_u8": [_IMG, _INT, _INT, _INT, _IMG, _INT, _INT] + [_I32] * 8,
    # a, alpha, b, beta, gamma, out, n
    "add_weighted_u8": [_IMG, ctypes.c_float, _IMG, ctypes.c_float, ctypes.c_float, _IMG,
                        ctypes.c_int64],
    # yuv, h, w, out
    "i420_to_bgr": [_IMG, _INT, _INT, _IMG],
}


def _native() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build_library(_SRC, "draw"))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _canvas(img: np.ndarray):
    """(img, h, w, channels) of a drawable image; raises on anything else."""
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) uint8 array, got "
                         f"{getattr(img, 'shape', None)} {getattr(img, 'dtype', type(img))}")
    nch = 1 if img.ndim == 2 else img.shape[2]
    if nch not in (1, 3, 4) or not img.flags.c_contiguous or not img.flags.writeable:
        raise ValueError(f"expected a writable C-contiguous image of 1, 3 or 4 channels, got "
                         f"shape {img.shape}")
    return img, img.shape[0], img.shape[1], nch


def _contours(contours: Sequence) -> tuple:
    """(N, 2) point arrays -> (flat int64 points, int32 counts)."""
    arrs = [np.asarray(c, dtype=np.int64).reshape(-1, 2) for c in contours]
    counts = np.array([len(a) for a in arrs], dtype=np.int32)
    pts = np.ascontiguousarray(np.concatenate(arrs) if arrs else np.zeros((0, 2), np.int64))
    return pts, counts


def polylines(img, contours, closed: bool, color: np.ndarray, thickness: int, line_type: int,
              shift: int = 0) -> None:
    """Each contour as a polyline (cv2 ``polylines``; one contour of two
    points is cv2's ``line``)."""
    img, h, w, nch = _canvas(img)
    pts, counts = _contours(contours)
    _native().draw_polylines(_ptr(img), h, w, nch, _ptr(pts), _ptr(counts), len(counts),
                             int(closed), _color(color, nch), int(thickness), int(line_type), int(shift))


def fill_convex_poly(img, points, color: np.ndarray, line_type: int, shift: int = 0) -> None:
    """cv2 ``fillConvexPoly``."""
    img, h, w, nch = _canvas(img)
    pts, counts = _contours([points])
    _native().draw_fill_convex(_ptr(img), h, w, nch, _ptr(pts), int(counts[0]), _color(color, nch),
                               int(line_type), int(shift))


def fill_poly(img, contours, color: np.ndarray, line_type: int, shift: int = 0,
              offset=(0, 0)) -> None:
    """cv2 ``fillPoly``: even-odd fill of every contour together."""
    img, h, w, nch = _canvas(img)
    pts, counts = _contours(contours)
    _native().draw_fill_poly(_ptr(img), h, w, nch, _ptr(pts), _ptr(counts), len(counts),
                             _color(color, nch), int(line_type), int(shift), int(offset[0]),
                             int(offset[1]))


def circles(img, centers, radii, color: np.ndarray, thicknesses, line_type: int,
            shift: int = 0) -> None:
    """cv2 ``circle`` at every (x, y) of ``centers`` in turn, one colour;
    ``radii`` and ``thicknesses`` one per centre or one for all."""
    img, h, w, nch = _canvas(img)
    pts = np.ascontiguousarray(np.asarray(centers, dtype=np.int64).reshape(-1, 2))
    n = len(pts)
    r = np.ascontiguousarray(np.broadcast_to(np.asarray(radii, np.int32), (n,)))
    t = np.ascontiguousarray(np.broadcast_to(np.asarray(thicknesses, np.int32), (n,)))
    _native().draw_circles(_ptr(img), h, w, nch, _ptr(pts), _ptr(r), _ptr(t), n, _color(color, nch),
                           int(line_type), int(shift))


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """cv2 ``addWeighted`` of two uint8 arrays of one shape: ``fma(src1,
    alpha, fma(src2, beta, gamma))`` in float32, rounded half to even,
    saturated."""
    a = np.ascontiguousarray(src1, dtype=np.uint8)
    b = np.ascontiguousarray(src2, dtype=np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"add_weighted of {a.shape} and {b.shape}")
    out = np.empty_like(a)
    _native().add_weighted_u8(_ptr(a), alpha, _ptr(b), beta, gamma, _ptr(out), a.size)
    return out


def blend_glyphs(img, alpha: np.ndarray, offs, gh, gw, gx, gy, color: np.ndarray) -> None:
    """Blend glyph coverage bitmaps into ``img``: glyph k is ``alpha[offs[k]:
    offs[k] + gh[k] * gw[k]]`` as a (gh, gw) array with its top-left
    corner at (gx[k], gy[k]) (clipped to the canvas):
    ``dst + ((color - dst) * a + 127) // 255`` on the colour channels, and a
    fourth channel takes ``a`` where it is non-zero (cv2 5's text)."""
    img, h, w, nch = _canvas(img)
    arrays = [np.ascontiguousarray(alpha, np.uint8), np.ascontiguousarray(offs, np.int64)]
    arrays += [np.ascontiguousarray(v, dtype=np.int32) for v in (gh, gw, gx, gy)]
    _native().blend_glyphs(_ptr(img), h, w, nch, *map(_ptr, arrays), len(arrays[1]),
                           _color(color, nch))


def resize_linear(src: np.ndarray, dst_hw, taps_x, taps_y) -> np.ndarray:
    """The integer passes of cv2's 8-bit ``INTER_LINEAR`` resize, given
    each axis's taps (source index 0 and 1, 11-bit weight 0 and 1 per
    output index; ``render/draw.resize_linear`` computes them)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    nch = 1 if src.ndim == 2 else src.shape[2]
    dh, dw = dst_hw
    dst = np.empty((dh, dw) + src.shape[2:], np.uint8)
    taps = [np.ascontiguousarray(v, dtype=np.int32) for v in (*taps_x, *taps_y)]
    _native().resize_linear_u8(_ptr(src), src.shape[0], src.shape[1], nch, _ptr(dst), dh, dw,
                               *map(_ptr, taps))
    return dst


def i420_to_bgr(yuv: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H*3/2, W) uint8 I420 -> (H, W, 3) uint8 BGR, as
    ``cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR_I420)``."""
    yuv = np.ascontiguousarray(yuv, dtype=np.uint8)
    if yuv.shape != (height * 3 // 2, width) or height % 2 or width % 2:
        raise ValueError(f"expected ({height * 3 // 2}, {width}) I420 with even sides, got "
                         f"{yuv.shape}")
    out = np.empty((height, width, 3), np.uint8)
    _native().i420_to_bgr(_ptr(yuv), height, width, _ptr(out))
    return out
