"""Text for the HUD without cv2: ``put_text`` and ``get_text_size``, the
counterparts of ``cv2.putText`` / ``cv2.getTextSize`` for the three faces
the JAX package draws with (``FONT_HERSHEY_SIMPLEX``, ``COMPLEX`` and
``TRIPLEX``), printable ASCII.

The cv2 the JAX package renders with (5.x) draws these faces as TrueType
glyphs of three weights, not as Hershey strokes: the face and the
thickness select the weight (:func:`_weight`; thickness thickens nothing
else), the pixel size is ``round(fontScale * 1000 / 37)``, each glyph is
blended from its coverage bitmap at an integer pen position, and the
advances are integers per size.  ``glyphs.npz`` (recovered offline from
cv2 renders by ``tests/test_torch_render.py::recover_glyph_table``)
holds per weight the advance and descent of every character at sizes
1-160 px, and the coverage bitmaps (``LINE_AA`` covers differently from
the other line types) at the sizes the HUD draws: 1-27 px (every
``fontScale`` up to 1), 77 and 81 px.  There the port draws cv2's
pixels; a size outside them draws the next larger table size's glyphs
resampled (nearest) to the pixel size, close to cv2's but not equal.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

from ..native.draw import blend_glyphs
from .draw import color_bytes

FONT_HERSHEY_SIMPLEX, FONT_HERSHEY_COMPLEX, FONT_HERSHEY_TRIPLEX = 0, 3, 4
LINE_AA = 16

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyphs.npz")
#: pixel size per unit of fontScale
_PX_PER_SCALE = 1000 / 37
_FIRST, _LAST = 32, 126


def _weight(font: int, thickness: int) -> int:
    """The glyph weight cv2 draws ``font`` at ``thickness`` with: 0 regular,
    1 bold, 2 heavy."""
    if font not in (FONT_HERSHEY_SIMPLEX, FONT_HERSHEY_COMPLEX, FONT_HERSHEY_TRIPLEX):
        raise ValueError(f"font {font} is not one of SIMPLEX (0), COMPLEX (3), TRIPLEX (4)")
    heavy = thickness > 1
    return {FONT_HERSHEY_SIMPLEX: int(heavy), FONT_HERSHEY_COMPLEX: 2 * heavy,
            FONT_HERSHEY_TRIPLEX: 1 + heavy}[font]


@functools.lru_cache(maxsize=1)
def _table():
    with np.load(_TABLE) as d:
        t = {k: d[k] for k in d.files}
    t["atlas"] = {int(px): i for i, px in enumerate(t["atlas_px"])}
    return t


def _pixel_size(font_scale: float) -> int:
    return int(round(font_scale * _PX_PER_SCALE))


def _codes(text: str) -> np.ndarray:
    """Character indices into the table; anything outside printable ASCII
    draws as '?', as cv2 draws it."""
    codes = np.frombuffer(text.encode("ascii", "replace"), np.uint8).astype(np.int64)
    codes[(codes < _FIRST) | (codes > _LAST)] = ord("?")
    return codes - _FIRST


def _advances(weight: int, px: int, codes: np.ndarray) -> np.ndarray:
    adv = _table()["adv"]
    if px < adv.shape[1]:
        return adv[weight, px, codes].astype(np.int64)
    top = adv.shape[1] - 1
    return (adv[weight, top, codes].astype(np.int64) * px) // top


def get_text_size(text: str, font_face: int, font_scale: float,
                  thickness: int) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize``: ((width, height), baseline) — the sum of the
    advances plus one, the pixel size, and the deepest descent."""
    if not text:
        return (0, 0), 0
    w, px = _weight(font_face, thickness), _pixel_size(font_scale)
    if px < 0:
        raise ValueError(f"get_text_size takes a font scale >= 0, got {font_scale}")
    codes = _codes(text)
    desc = _table()["desc"]
    base = int(desc[w, min(px, desc.shape[1] - 1), codes].max())
    if px >= desc.shape[1]:
        base = base * px // (desc.shape[1] - 1)
    return (int(_advances(w, px, codes).sum()) + 1, px), base


@functools.lru_cache(maxsize=4096)
def _resampled(weight: int, px: int, code: int, aa: bool):
    """(coverage, dx, dy) of one glyph at a size the table lacks: the next
    larger table size's (or the largest) resampled (nearest) to ``px``."""
    t = _table()
    sizes = t["atlas_px"]
    src = int(sizes[sizes >= px].min()) if (sizes >= px).any() else int(sizes.max())
    off, h, w, dx, dy = (int(v) for v in t["index"][weight, t["atlas"][src], code, int(aa)])
    pix = t["alpha"][off: off + h * w].reshape(h, w)
    if h == 0:
        return pix, 0, 0
    r = px / src
    x0, y0 = int(np.floor(dx * r)), int(np.floor(dy * r))
    x1, y1 = int(np.ceil((dx + w) * r)), int(np.ceil((dy + h) * r))
    xs = np.floor((np.arange(x0, x1) + 0.5) / r).astype(np.int64) - dx
    ys = np.floor((np.arange(y0, y1) + 0.5) / r).astype(np.int64) - dy
    okx, oky = (xs >= 0) & (xs < w), (ys >= 0) & (ys < h)
    out = np.zeros((y1 - y0, x1 - x0), np.uint8)
    out[np.ix_(oky, okx)] = pix[np.ix_(ys[oky], xs[okx])]
    return out, x0, y0


@functools.lru_cache(maxsize=4096)
def _layout(text: str, weight: int, px: int, aa: bool):
    """A string's glyphs relative to its origin: (coverage buffer, offsets,
    heights, widths, x, y), ready for the native blend (the HUD draws the
    same strings frame after frame)."""
    t = _table()
    codes = _codes(text)
    pens = np.concatenate([[0], np.cumsum(_advances(weight, px, codes))[:-1]])
    if px in t["atlas"]:
        off, h, w, dx, dy = t["index"][weight, t["atlas"][px], codes, int(aa)].T
        buf = t["alpha"]
    else:
        glyphs = [_resampled(weight, px, int(c), aa) for c in codes]
        sizes = [g[0].size for g in glyphs]
        off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        buf = np.concatenate([g[0].reshape(-1) for g in glyphs] + [np.zeros(1, np.uint8)])
        h, w = [g[0].shape[0] for g in glyphs], [g[0].shape[1] for g in glyphs]
        dx, dy = [g[1] for g in glyphs], [g[2] for g in glyphs]
    i32 = [np.ascontiguousarray(v, dtype=np.int32) for v in (h, w, pens + np.asarray(dx), dy)]
    return (buf, np.ascontiguousarray(off, dtype=np.int64), *i32)


def put_text(img: np.ndarray, text: str, org, font_face: int, font_scale: float, color,
             thickness: int = 1, line_type: int = 8) -> np.ndarray:
    """``cv2.putText`` (baseline-left origin ``org``) in place on a uint8
    (H, W[, C]) image: each glyph's coverage ``a`` (of ``line_type``)
    blends ``dst + ((color - dst) * a + 127) // 255`` into the colour
    channels, and on a 4-channel image becomes the alpha where it is
    non-zero, as cv2 blends; one native call per string.  A scale under
    half a pixel draws nothing (cv2 draws nothing at 0; a negative
    scale, which cv2 draws otherwise, draws nothing here)."""
    if not text:
        return img
    weight, px = _weight(font_face, thickness), _pixel_size(font_scale)
    if px <= 0:
        return img
    buf, off, gh, gw, gx, gy = _layout(text, weight, px, line_type == LINE_AA)
    nch = 1 if img.ndim == 2 else img.shape[2]
    blend_glyphs(img, buf, off, gh, gw, gx + np.int32(org[0]), gy + np.int32(org[1]),
                 color_bytes(color, nch))
    return img
