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
- BMP, as OpenCV's ``BmpDecoder`` reads it: 1-, 4- and 8-bit palettes
  (cv2's own gray BMP is 8-bit), RLE8 and RLE4 (end of line, end of bitmap
  and deltas fill what they skip with palette entry 0, as OpenCV does),
  16-bit 5-5-5 (``BI_RGB``) and 5-6-5 (``BI_BITFIELDS``), 24-bit, and
  32-bit ``BI_RGB`` or ``BI_BITFIELDS`` (read as B, G, R, A bytes whatever
  the masks, as OpenCV reads them); bottom-up or top-down; the 40-byte and
  longer headers and OS/2's 12-byte one.  Another kind raises a
  ``ValueError`` that names it.
- JPEG: baseline, extended sequential and progressive 8-bit Huffman, gray
  or YCbCr 4:4:4, 4:2:2, 4:4:0 and 4:2:0, with restart intervals, decoded
  as libjpeg-turbo decodes for cv2 (``native/image.cpp``): equal to
  ``cv2.imread`` to the bit.  Arithmetic-coded, lossless, hierarchical
  and 12-bit JPEGs raise a ``ValueError`` that names them, and so does a
  progressive file whose scans leave some of the first coefficients
  unsent or unrefined (libjpeg-turbo would smooth its blocks).

The EXIF Orientation tag (0x0112) of a JPEG's ``Exif`` APP1 segments or of
a PNG's ``eXIf`` chunk turns and flips the image as ``cv2.imread`` does
(``exif_orientation``, ``orient``); EXIF that cv2 cannot read is passed
over, as cv2 passes over it.

Corrupt or truncated data, and an image of more than ``MAX_PIXELS``
pixels, raise a ``ValueError`` that names what was wrong (cv2 prints a
warning and returns None).

``imwrite(path, img)`` / ``imencode(ext, img)`` write by the suffix, byte
for byte what ``cv2.imencode`` writes for a JPEG (``.jpg``, ``.jpeg``,
``.jpe``: cv2's defaults, quality 95 and 4:2:0; gray as one component,
BGRA without its alpha) and a BMP (8-bit gray with its gray palette,
24-bit BGR, 32-bit BGRA), and a PNG (8-bit gray, BGR or BGRA) that cv2
reads back as written.

The library is built with g++ into ``adas_tpu_torch/_build/libimage.so``
on first use (``native/gxx.py``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional, Tuple

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
    1: "corrupt JPEG data", 3: "arithmetic-coded JPEG is not supported",
    4: "lossless JPEG is not supported", 5: "hierarchical JPEG is not supported",
    6: "only 8-bit JPEG samples are supported",
    7: "only 1- or 3-component JPEGs are supported",
    8: "unsupported JPEG sampling factors (luma up to 2x2, chroma 1x1)",
    9: "JPEG has no frame header", 10: "truncated JPEG",
    11: "progressive JPEG whose scans leave some of the first ten coefficients unsent or "
        "unrefined is not supported (libjpeg-turbo smooths its blocks)",
    12: "corrupt progressive JPEG: bad scan parameters (Ss, Se, Ah, Al)",
}
#: ``cv2.imencode('.jpg', img)``'s quality (cv2's default)
JPEG_QUALITY = 95
JPEG_SUFFIXES = (".jpg", ".jpeg", ".jpe")


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
                lib.bmp_decode.argtypes = [p, l, i, i, i, i, p, i, p]
                for f in (lib.png_decode, lib.jpeg_info, lib.jpeg_decode, lib.bmp_decode):
                    f.restype = i
                lib.jpeg_encode.argtypes = [p, i, i, i, l, i, p, l]
                lib.jpeg_encode.restype = l
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
    """An encoded PNG, BMP or JPEG -> (H, W, 3) uint8 BGR, turned as its
    EXIF Orientation says (None for another format)."""
    if data[:8] == _PNG_MAGIC:
        img, orientation = _decode_png(data)
        return orient(img, orientation)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:2] == b"\xff\xd8":
        return orient(_decode_jpeg(data), _jpeg_orientation(data))
    return None


# ---------------------------------------------------------------- EXIF

#: the IFD0 tags OpenCV's ``ExifReader`` parses besides Orientation: a
#: string (whose offset must lie in the block), a 16-bit value, or that
#: many rationals at an offset.  Reading one out of the block ends the
#: parse; the tags read before it stay read.
_EXIF_STRINGS = frozenset((0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298))
_EXIF_SHORTS = frozenset((0x0128, 0x0213))
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
ORIENTATION_TAG = 0x0112


class _OutOfBlock(Exception):
    pass


def exif_orientation(tiff: bytes) -> Optional[int]:
    """The Orientation value of a TIFF-structured EXIF block (``II`` or
    ``MM`` byte order; OpenCV reads any other mark as ``MM``), as OpenCV's
    ``ExifReader`` reads it from IFD0: the tag's first 16 bits whatever
    its type and count.  None when the block has none, or cannot be read
    as far as it."""
    order = "<" if tiff[:2] == b"II" else ">"
    n = len(tiff)

    def u16(o):
        if o + 1 >= n:
            raise _OutOfBlock
        return struct.unpack_from(order + "H", tiff, o)[0]

    def u32(o):
        if o + 3 >= n:
            raise _OutOfBlock
        return struct.unpack_from(order + "I", tiff, o)[0]

    try:
        if u16(2) != 0x2A:
            return None
        pos = u32(4)
        entries = u16(pos)
        pos += 2
        for _ in range(entries):
            tag = u16(pos)
            if tag == ORIENTATION_TAG:
                return u16(pos + 8)
            if tag in _EXIF_SHORTS:
                u16(pos + 8)
            elif tag in _EXIF_STRINGS:
                size = u32(pos + 4)
                at = u32(pos + 8) if size > 4 else 8
                if at > n or at + size > n:
                    raise _OutOfBlock
            elif tag in _EXIF_RATIONALS:
                at = u32(pos + 8)
                for i in range(2 * _EXIF_RATIONALS[tag]):
                    u32(at + 4 * i)
            pos += 12
    except _OutOfBlock:
        pass
    return None


def _jpeg_orientation(data: bytes) -> Optional[int]:
    """The first Orientation read from the ``Exif`` APP1 segments before
    the first scan, in file order (cv2 reads every such segment)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\0\0":
            value = exif_orientation(body[6:])
            if value is not None:
                return value
        pos += 2 + max(length, 2)
    return None


def orient(img: np.ndarray, orientation: Optional[int]) -> np.ndarray:
    """``img`` turned as OpenCV's ``ExifTransform`` turns it for an EXIF
    Orientation (2 and 4 flip, 3 turns half round, 5-8 transpose and then
    flip; any other value leaves it)."""
    if orientation is None or not 2 <= orientation <= 8:
        return img
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1), 8: (0,)}[orientation]
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def _check_size(kind: str, w: int, h: int) -> None:
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{kind} of {w}x{h} pixels is empty or larger than {MAX_PIXELS}")


def _decode_png(data: bytes) -> Tuple[np.ndarray, Optional[int]]:
    """The image and the Orientation of its ``eXIf`` chunk: the first
    before IEND that libpng takes (a good CRC, at least 4 bytes, a TIFF
    header); libpng drops the later ones."""
    pos, idat, palette, header, exif = 8, [], b"", None, None
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
        elif kind == b"eXIf" and exif is None and n >= 4 and \
                body[:4] in (b"II*\0", b"MM\0*") and \
                data[pos + 8 + n:pos + 12 + n] == struct.pack(">I", zlib.crc32(kind + body)):
            exif = body
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
    return out, None if exif is None else exif_orientation(exif)


#: BMP compression methods (biCompression)
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("truncated BMP header")
    return struct.unpack_from("<I", data, at)[0]


def _decode_bmp(data: bytes) -> np.ndarray:
    """A BMP as OpenCV's ``BmpDecoder`` reads it (``grfmt_bmp.cpp``): the
    header fields it reads, where it reads them (the palette and a 16-bit
    file's masks right after the header, whatever its size), and the kinds
    it takes."""
    offset, size = _u32(data, 10), _u32(data, 14)
    top_down = False
    if size >= 36:
        if len(data) < 50:
            raise ValueError("truncated BMP header")
        w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        colours = _u32(data, 46)
        top_down = h < 0
        h = abs(h)
        kinds = {(1, BI_RGB), (4, BI_RGB), (8, BI_RGB), (24, BI_RGB), (32, BI_RGB),
                 (16, BI_RGB), (16, BI_BITFIELDS), (32, BI_BITFIELDS), (4, BI_RLE4),
                 (8, BI_RLE8)}
        if (bits, compression) not in kinds:
            raise ValueError(f"{bits}-bit BMP of compression method {compression} is not "
                             f"supported (cv2 reads 1/4/8-bit palettes, RLE4, RLE8, 16-bit "
                             f"5-5-5 and 5-6-5, 24- and 32-bit)")
        table = 14 + size  # the palette or the masks follow the header
        if bits <= 8:
            if colours > 256:
                raise ValueError(f"BMP with {colours} palette colours")
            n = colours or 1 << bits
            if table + 4 * n > len(data):
                raise ValueError("truncated BMP palette")
            palette = np.zeros((256, 4), np.uint8)
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, table).reshape(n, 4)
        elif bits == 16:
            if compression == BI_BITFIELDS:
                masks = struct.unpack_from("<III", data, table) if table + 12 <= len(data) \
                    else None
                if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
                    raise ValueError(f"16-bit BMP bit fields {masks} are not supported "
                                     f"(5-5-5 and 5-6-5 are)")
                bits = 15 if masks[0] == 0x7C00 else 16
            else:
                bits = 15
    elif size == 12:  # OS/2 BITMAPCOREHEADER: a 3-byte palette, no compression
        if len(data) < 26:
            raise ValueError("truncated BMP header")
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression = BI_RGB
        if bits not in (1, 4, 8, 24):
            raise ValueError(f"{bits}-bit OS/2 BMP is not supported (cv2 reads 1/4/8 and 24 "
                             f"bits)")
        if bits <= 8:
            n = 1 << bits
            if 26 + 3 * n > len(data):
                raise ValueError("truncated BMP palette")
            palette = np.zeros((256, 4), np.uint8)
            palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
    else:
        raise ValueError(f"BMP with a {size}-byte header is not supported")
    if w <= 0 or h == 0:
        raise ValueError(f"BMP of {w}x{h} pixels")
    _check_size("BMP", w, h)
    if offset > len(data):
        raise ValueError("truncated BMP pixel data")
    if bits in (24, 32):
        nb = bits // 8
        stride = (w * nb + 3) & ~3
        if offset + stride * h > len(data):
            raise ValueError("truncated BMP pixel data")
        rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset)
        img = rows.reshape(h, stride)[:, :w * nb].reshape(h, w, nb)[..., :3]
        return np.ascontiguousarray(img if top_down else img[::-1])
    out = np.empty((h, w, 3), np.uint8)
    pal = palette if bits <= 8 else np.zeros((256, 4), np.uint8)
    rle = {BI_RLE8: 1, BI_RLE4: 2}.get(compression, 0)
    pixels = data[offset:]
    err = _native().bmp_decode(pixels, len(pixels), w, h, bits, rle, pal.ctypes.data,
                               int(top_down), out.ctypes.data)
    if err:
        raise ValueError("truncated BMP pixel data" if err == 1 else
                         "corrupt BMP RLE data: a run passes the end of its line")
    return out


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


def jpeg_encode(img: np.ndarray) -> bytes:
    """``cv2.imencode('.jpg', img)``'s bytes at cv2's defaults (quality
    ``JPEG_QUALITY``, 4:2:0, libjpeg-turbo's standard Huffman tables, no
    restarts): (H, W) gray as one component, (H, W, 3) BGR, (H, W, 4) BGRA
    without its alpha."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    lib = _native()
    cap = h * w * 3 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, w, h, nch, w * nch, JPEG_QUALITY, out.ctypes.data,
                            cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n


def bmp_encode(img: np.ndarray) -> bytes:
    """``cv2.imencode('.bmp', img)``'s bytes: bottom-up rows, no
    resolution; 8-bit gray with a gray palette, 24-bit BGR, or 32-bit BGRA
    behind a 124-byte (V5) header with its B, G, R, A masks and sRGB."""
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    stride = (w * nch + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * nch] = img[::-1].reshape(h, -1)
    table = b""
    if nch == 1:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
        palette[:, 3] = 0
        table = palette.tobytes()
    size, compression, extra = 40, BI_RGB, b""
    if nch == 4:
        size, compression = 124, BI_BITFIELDS
        extra = struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + b"BGRs"
        extra += bytes(size - 40 - len(extra))
    offset = 14 + size + len(table)
    header = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", size, w, h, 1, nch * 8, compression, 0, 0, 0, 0, 0)
    return header + info + extra + table + rows.tobytes()


def imencode(ext: str, img: np.ndarray) -> bytes:
    """``img`` (8-bit (H, W), (H, W, 3) BGR or (H, W, 4) BGRA) encoded as
    ``.jpg`` / ``.jpeg`` / ``.jpe`` or ``.bmp`` (``cv2.imencode``'s bytes)
    or ``.png`` (cv2 reads it back as written)."""
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
        return bmp_encode(img)
    if ext in JPEG_SUFFIXES:
        if h > 65535 or w > 65535:
            raise ValueError(f"a JPEG holds at most 65535x65535 pixels, got {w}x{h}")
        return jpeg_encode(img)
    raise ValueError(f"unsupported image format {ext!r} (write .jpg, .png or .bmp)")


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite``: JPEG, PNG or BMP by the suffix; returns True."""
    data = imencode(os.path.splitext(path)[1], img)
    with open(path, "wb") as f:
        f.write(data)
    return True
