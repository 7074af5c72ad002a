"""Still images without cv2 or PIL: ``imread`` and ``imwrite`` with
``cv2.imread(path, cv2.IMREAD_COLOR)`` / ``cv2.imwrite``'s semantics, for
the lane demo and ``quantize --calib-dir`` (the machine that serves the
port has neither package).

``imread(path)`` -> (H, W, 3) uint8 BGR, or None when the file is missing
or is no PNG, BMP or JPEG (as cv2 returns None):

- PNG: gray, gray + alpha, RGB, RGBA and palette; 1-16 bit samples; the
  five row filters; Adam7 interlacing.  The chunks are parsed here and the
  IDAT stream inflated with the standard library's ``zlib``; the pixel
  loops are C++ (``native/image.cpp``).  Alpha is dropped, 16-bit samples
  keep their high byte, as OpenCV's libpng reader gives them; ancillary
  chunks (gAMA, tRNS, ...) are not applied, nor are they by OpenCV.
- BMP: 24- and 32-bit uncompressed (``BI_RGB``, and ``BI_BITFIELDS`` with
  the standard masks), bottom-up or top-down; the alpha byte dropped.
- JPEG: baseline and extended sequential 8-bit Huffman, gray or YCbCr
  4:4:4, 4:2:2, 4:4:0 and 4:2:0, with restart intervals, decoded as
  libjpeg-turbo decodes for cv2 (``native/image.cpp``): equal to
  ``cv2.imread`` to the bit.  Progressive, arithmetic-coded, lossless,
  hierarchical and 12-bit JPEGs raise a ``ValueError`` that names them.

Corrupt or truncated data, and an image of more than ``MAX_PIXELS``
pixels, raise a ``ValueError`` that names what was wrong (cv2 prints a
warning and returns None).

``imwrite(path, img)`` writes PNG (8-bit gray, BGR or BGRA) and BMP
(24-bit, or 32-bit for BGRA) by the path's suffix; a ``.jpg``/``.jpeg``
raises (no JPEG encoder is ported).

The library is built with g++ into ``adas_tpu_torch/_build/libimage.so``
on first use (``native/gxx.py``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ..native.gxx import build_library

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "image.cpp")
_LOCK = threading.Lock()
_lib = None

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: the suffixes read as still images (the JAX CLIs' list)
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")
#: the largest image read, in pixels (OpenCV's CV_IO_MAX_IMAGE_PIXELS)
MAX_PIXELS = 1 << 30
#: native/image.cpp's JPEG error codes
_JPEG_ERRORS = {
    1: "corrupt JPEG data", 2: "progressive JPEG is not supported",
    3: "arithmetic-coded JPEG is not supported", 4: "lossless JPEG is not supported",
    5: "hierarchical JPEG is not supported", 6: "only 8-bit JPEG samples are supported",
    7: "only 1- or 3-component JPEGs are supported",
    8: "unsupported JPEG sampling factors (luma up to 2x2, chroma 1x1)",
    9: "JPEG has no frame header", 10: "truncated JPEG",
}


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(_SRC, "image"))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                lib.png_decode.argtypes = [p, l, i, i, i, i, i, p, i, p]
                lib.jpeg_info.argtypes = [p, l, p, p, p]
                lib.jpeg_decode.argtypes = [p, l, i, i, p]
                for f in (lib.png_decode, lib.jpeg_info, lib.jpeg_decode):
                    f.restype = i
                _lib = lib
    return _lib


def imread(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_COLOR)``: (H, W, 3) uint8 BGR, or
    None for a missing file or one of another format."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode(data)


def imdecode(data: bytes) -> Optional[np.ndarray]:
    """An encoded PNG, BMP or JPEG -> (H, W, 3) uint8 BGR (None for another
    format)."""
    if data[:8] == _PNG_MAGIC:
        return _decode_png(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    return None


def _check_size(kind: str, w: int, h: int) -> None:
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{kind} of {w}x{h} pixels is empty or larger than {MAX_PIXELS}")


def _decode_png(data: bytes) -> np.ndarray:
    pos, idat, palette, header = 8, [], b"", None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError("truncated PNG")
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"corrupt PNG: a {n}-byte IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in (0, 2, 3, 4, 6) or depth not in (1, 2, 4, 8, 16) or \
            (color_type in (2, 4, 6) and depth < 8) or (color_type == 3 and depth > 8):
        raise ValueError(f"invalid PNG: colour type {color_type}, bit depth {depth}")
    _check_size("PNG", w, h)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    out = np.zeros((h, w, 3), np.uint8)
    pal = np.frombuffer(palette, np.uint8) if palette else np.zeros(3, np.uint8)
    err = _native().png_decode(raw, len(raw), w, h, color_type, depth, interlace,
                               pal.ctypes.data, len(palette) // 3, out.ctypes.data)
    if err:
        raise ValueError("corrupt PNG data: " + ("unknown filter type" if err == -1
                                                 else "image data too short"))
    return out


def _decode_bmp(data: bytes) -> np.ndarray:
    if len(data) < 54:
        raise ValueError("truncated BMP header")
    offset = struct.unpack_from("<I", data, 10)[0]
    size = struct.unpack_from("<I", data, 14)[0]
    if size < 40:
        raise ValueError(f"BMP with a {size}-byte header is not supported")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    if bits not in (24, 32):
        raise ValueError(f"{bits}-bit BMP is not supported (24 and 32 are)")
    if compression == 3 and bits == 32:  # BI_BITFIELDS: the standard BGRX masks only
        if len(data) < 66:
            raise ValueError("truncated BMP header")
        masks = struct.unpack_from("<III", data, 54)
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"BMP bit fields {[hex(m) for m in masks]} are not supported")
    elif compression != 0:
        raise ValueError(f"compressed BMP (method {compression}) is not supported")
    _check_size("BMP", w, abs(h))
    nb = bits // 8
    stride = (w * nb + 3) & ~3
    if offset + stride * abs(h) > len(data):
        raise ValueError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * abs(h), offset=offset)
    img = rows.reshape(abs(h), stride)[:, :w * nb].reshape(abs(h), w, nb)[..., :3]
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = _native()
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(n))
    if not err:
        _check_size("JPEG", w.value, h.value)
        out = np.empty((h.value, w.value, 3), np.uint8)
        err = lib.jpeg_decode(data, len(data), w.value, h.value, out.ctypes.data)
    if err:
        raise ValueError(_JPEG_ERRORS.get(err, f"JPEG decode error {err}"))
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def imencode(ext: str, img: np.ndarray) -> bytes:
    """``img`` (8-bit (H, W), (H, W, 3) BGR or (H, W, 4) BGRA) encoded as
    ``.png`` or ``.bmp`` (``cv2.imencode``'s role; cv2 reads it back as
    written)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] not in (1, 3, 4)):
        raise ValueError(f"imwrite takes 8-bit gray, BGR or BGRA, got {img.shape} {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    ext = ext.lower()
    if ext == ".png":
        nch = 1 if img.ndim == 2 else img.shape[2]
        pix = img if nch == 1 else img[..., [2, 1, 0, 3][:nch]]  # RGB(A) order
        rows = np.concatenate([np.zeros((h, 1), np.uint8), pix.reshape(h, -1)], axis=1)
        color_type = {1: 0, 3: 2, 4: 6}[nch]
        return (_PNG_MAGIC + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                                             0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))
    if ext == ".bmp":
        bgr = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
        nb = bgr.shape[2]
        stride = (w * nb + 3) & ~3
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w * nb] = bgr[::-1].reshape(h, -1)
        header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, nb * 8, 0, rows.size, 2835, 2835, 0, 0)
        return header + info + rows.tobytes()
    if ext in (".jpg", ".jpeg", ".jpe"):
        raise ValueError("JPEG encoding is not ported (write .png or .bmp)")
    raise ValueError(f"unsupported image format {ext!r} (write .png or .bmp)")


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite``: PNG or BMP by the suffix; returns True."""
    data = imencode(os.path.splitext(path)[1], img)
    with open(path, "wb") as f:
        f.write(data)
    return True
