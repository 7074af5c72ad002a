"""The port's drawing primitives, named after the cv2 calls they replace
(the JAX package draws with cv2; the card's host has none).

Strokes, fills, ``add_weighted`` and the integer passes of
``resize_linear`` run in C++ (``native/draw.py``); ``copy_make_border``
and ``rotate_icon`` are numpy with cv2's integer arithmetic.  Every
drawing function draws in place on a C-contiguous uint8 image, as cv2
does on a ``np.ndarray``, and takes cv2's arguments: points as (x, y),
colours as up to four channel values saturated to 0..255, ``thickness``
-1 for a filled shape, ``line_type`` 4, 8 or ``LINE_AA``.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np

from ..native import draw as _native

LINE_4, LINE_8, LINE_AA = 4, 8, 16


def color_bytes(color, nch: int) -> np.ndarray:
    """cv2's ``scalarToRawData`` for 8-bit images: the first ``nch`` values
    of ``color`` (missing ones 0), rounded half to even and saturated."""
    try:
        return _color_bytes(tuple(color) if np.ndim(color) else (color,), nch)
    except TypeError:  # an unhashable value: no cache
        return _color_bytes.__wrapped__(tuple(np.atleast_1d(color).tolist()), nch)


@functools.lru_cache(maxsize=1024)
def _color_bytes(color: tuple, nch: int) -> np.ndarray:
    vals = np.zeros(4, np.float64)
    c = np.asarray(color[:4], dtype=np.float64)
    vals[: len(c)] = c
    out = np.ascontiguousarray(np.clip(np.rint(vals[:nch]), 0, 255).astype(np.uint8))
    out.flags.writeable = False
    return out


def _nch(img: np.ndarray) -> int:
    return 1 if img.ndim == 2 else img.shape[2]


def _pt(p) -> tuple:
    return int(p[0]), int(p[1])


def line(img, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8, shift: int = 0):
    """``cv2.line``."""
    if thickness <= 0:
        raise ValueError(f"line thickness must be positive, got {thickness}")
    _native.polylines(img, [[_pt(pt1), _pt(pt2)]], False, color_bytes(color, _nch(img)),
                      thickness, line_type, shift)
    return img


def arrowed_line(img, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8,
                 shift: int = 0, tip_length: float = 0.1):
    """``cv2.arrowedLine``: the shaft, then two tip strokes of
    ``tip_length`` times the shaft's length at +-45 degrees."""
    if thickness <= 0:
        raise ValueError(f"line thickness must be positive, got {thickness}")
    (x1, y1), (x2, y2) = _pt(pt1), _pt(pt2)
    tip = math.hypot(x1 - x2, y1 - y2) * tip_length
    angle = math.atan2(y1 - y2, x1 - x2)
    strokes = [[(x1, y1), (x2, y2)]] + [
        [(round(x2 + tip * math.cos(a)), round(y2 + tip * math.sin(a))), (x2, y2)]
        for a in (angle + math.pi / 4, angle - math.pi / 4)]
    # three cv2.line calls in order, as three 2-point polylines in one call
    _native.polylines(img, strokes, False, color_bytes(color, _nch(img)), thickness, line_type,
                      shift)
    return img


def circle(img, center, radius: int, color, thickness: int = 1, line_type: int = LINE_8,
           shift: int = 0):
    """``cv2.circle``."""
    return circles(img, [center], radius, color, thickness, line_type, shift)


def circles(img, centers, radius, color, thickness=1, line_type: int = LINE_8,
            shift: int = 0):
    """``cv2.circle`` at each of ``centers`` in turn, in one native call;
    ``radius`` and ``thickness`` one per centre or one for all."""
    if np.any(np.asarray(radius) < 0):
        raise ValueError(f"circle radius must be >= 0, got {radius}")
    if len(centers):
        _native.circles(img, centers, radius, color_bytes(color, _nch(img)), thickness,
                        line_type, shift)
    return img


def polylines(img, pts: Sequence, is_closed: bool, color, thickness: int = 1,
              line_type: int = LINE_8, shift: int = 0):
    """``cv2.polylines``."""
    _native.polylines(img, pts, is_closed, color_bytes(color, _nch(img)), thickness, line_type,
                      shift)
    return img


def fill_poly(img, pts: Sequence, color, line_type: int = LINE_8, shift: int = 0,
              offset=(0, 0)):
    """``cv2.fillPoly`` (convex or not; contours filled together, even-odd)."""
    _native.fill_poly(img, pts, color_bytes(color, _nch(img)), line_type, shift, offset)
    return img


def rectangle(img, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8,
              shift: int = 0):
    """``cv2.rectangle``: a closed polyline of the four corners, or for a
    negative thickness the convex fill (an anti-aliased fill blends its
    edges as cv2's does)."""
    (x1, y1), (x2, y2) = _pt(pt1), _pt(pt2)
    quad = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    c = color_bytes(color, _nch(img))
    if thickness >= 0:
        _native.polylines(img, [quad], True, c, thickness, line_type, shift)
    else:
        _native.fill_convex_poly(img, quad, c, line_type, shift)
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """``cv2.addWeighted`` on uint8: ``src1 * alpha + src2 * beta + gamma``
    in float32 with cv2's two fused multiply-adds, rounded half to even
    and saturated."""
    if src1.shape != src2.shape or src1.dtype != np.uint8 or src2.dtype != np.uint8:
        raise ValueError(f"expected two uint8 arrays of one shape, got {src1.shape} "
                         f"{src1.dtype} and {src2.shape} {src2.dtype}")
    return _native.add_weighted(src1, alpha, src2, beta, gamma)


def copy_make_border(src: np.ndarray, top: int, bottom: int, left: int, right: int,
                     value=0) -> np.ndarray:
    """``cv2.copyMakeBorder`` with ``BORDER_CONSTANT``."""
    h, w = src.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + src.shape[2:], src.dtype)
    out[...] = color_bytes(value, _nch(src)) if src.dtype == np.uint8 else value
    out[top: top + h, left: left + w] = src
    return out


#: cv2's fixed-point linear resize of 8-bit images: 11-bit coefficients
_RESIZE_BITS = 11
_RESIZE_ONE = 1 << _RESIZE_BITS


@functools.lru_cache(maxsize=64)
def _resize_taps(src: int, dst: int):
    """Per output index: the two source indices and their 11-bit weights,
    as cv2's ``INTER_LINEAR`` computes them: the source position in
    float32 from ``scale = 1 / (dst / src)`` (half-pixel centres), edges
    clamped, weights ``cvRound(w * 2048)`` of the float32 fractions."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    lo = sx < 0
    fx[lo], sx[lo] = 0, 0
    hi = sx >= src - 1
    fx[hi], sx[hi] = 0, src - 1
    one = np.float32(_RESIZE_ONE)
    w1 = np.rint(fx * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - fx) * one).astype(np.int64)
    return sx, np.minimum(sx + 1, src - 1), w0, w1


def resize_linear(src: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_LINEAR)`` on a
    uint8 (H, W[, C]) image, ``dsize`` = (width, height): cv2's taps
    (:func:`_resize_taps`) and its integer passes (``native/draw.cpp``),
    equal to cv2's when downscaling (the HUD's inset, ``host_downscale``;
    an upscale can differ by one level)."""
    if src.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, got {src.dtype}")
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = src.shape[:2]
    if (dw, dh) == (w, h):
        return src.copy()
    return _native.resize_linear(src, (dh, dw), _resize_taps(w, dw), _resize_taps(h, dh))


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the 2x3 affine rotation by ``angle``
    degrees (counter-clockwise) about ``center``."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def rotate_icon(img: np.ndarray, angle: float) -> np.ndarray:
    """``cv2.warpAffine(img, cv2.getRotationMatrix2D((s/2, s/2), angle, 1),
    (s, s))`` for a square icon and ``angle`` a multiple of 90 degrees.
    Such a matrix maps every pixel centre onto a pixel centre (cv2's
    10-bit map rounds its cos-of-90-degree residue away), so the warp is
    a nearest gather with zero outside; but it rotates about (s/2, s/2),
    not the icon's centre (s-1)/2, so the result is ``np.rot90`` moved by
    one pixel."""
    s = img.shape[0]
    if img.shape[1] != s or angle % 90:
        raise ValueError(f"rotate_icon takes a square icon and a multiple of 90 degrees, got "
                         f"{img.shape} and {angle}")
    m = rotation_matrix_2d((s / 2, s / 2), angle, 1.0)
    inv = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:s, 0:s]
    # cv2 evaluates the inverse map in 10-bit fixed point per pixel
    sx = np.rint(inv[0, 0] * xs * 1024).astype(np.int64) + np.rint(
        (inv[0, 1] * ys + inv[0, 2]) * 1024).astype(np.int64)
    sy = np.rint(inv[1, 0] * xs * 1024).astype(np.int64) + np.rint(
        (inv[1, 1] * ys + inv[1, 2]) * 1024).astype(np.int64)
    sx, sy = (sx + 512) >> 10, (sy + 512) >> 10
    ok = (sx >= 0) & (sx < s) & (sy >= 0) & (sy < s)
    out = np.zeros_like(img)
    out[ys[ok], xs[ok]] = img[sy[ok], sx[ok]]
    return out
