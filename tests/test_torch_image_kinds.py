"""EXIF orientation and the BMP kinds of the port's still-image reader
(``adas_tpu_torch/render/image.py`` over ``native/image.cpp``) against
``cv2.imread(path, cv2.IMREAD_COLOR)`` / ``cv2.imdecode``.

Bound: equal to the bit, and None from cv2 exactly where the port raises
``ValueError``.

* EXIF: ``Exif`` APP1 segments (one to three, anywhere before the first
  scan, some behind XMP or with another prefix) and PNG ``eXIf`` chunks
  (before or after IDAT, some with a bad CRC) of seeded TIFF blocks: both
  byte orders and cv2's reading of any other mark, IFD0 entries of the
  tags OpenCV's ``ExifReader`` parses with offsets in and out of the
  block, counts and types of every kind, Orientation 0-10, a wrong TIFF
  mark or IFD offset, blocks cut short.  cv2 takes the first Orientation
  it reads and passes over a block it cannot read past, as the port does.
* BMP: seeded files of every kind cv2's ``BmpDecoder`` takes (1/4/8-bit
  palettes, short palettes, RLE8 and RLE4 with every escape, 16-bit 5-5-5
  and 5-6-5, 32-bit bit fields, 24-bit, the 12-byte OS/2, 40-byte and
  124-byte headers, top-down) and of kinds it refuses.  Files cv2 decodes
  differently run to run (pixels its RLE decoder leaves unwritten) are
  skipped.
"""
import random
import struct
import zlib

import cv2
import numpy as np
import pytest

from adas_tpu_torch.render import image

#: IFD0 tags OpenCV's ExifReader parses, an unknown one and the EXIF offset
TAGS = [0x010E, 0x010F, 0x0110, 0x0112, 0x011A, 0x011B, 0x0128, 0x0131, 0x0132, 0x013E, 0x013F,
        0x0211, 0x0213, 0x0214, 0x8298, 0x8769, 0x9999, 0x0112]


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _port(data):
    try:
        return image.imdecode(data)
    except ValueError:
        return None


def _same(data):
    want, got = _cv2(data), _port(data)
    assert (want is None) == (got is None)
    if want is not None:
        assert want.shape == got.shape
        np.testing.assert_array_equal(got, want)
    return want


def _tiff(rng):
    order = rng.choice("<>")
    mark = {"<": b"II", ">": b"MM"}[order] if rng.random() < 0.9 else \
        rng.choice([b"IM", b"XX", b"MI"])
    n = rng.randint(0, 6)
    guess = 8 + 2 + 12 * n + 4 + 40
    entries = []
    for _ in range(n):
        tag = rng.choice(TAGS)
        if tag == 0x0112 and rng.random() < 0.8:
            value = struct.pack(order + "HH", rng.randint(0, 10), 0)
        else:
            value = struct.pack(order + "I", rng.choice([0, 8, 20, 40, guess - 8, guess, 5000,
                                                         2 ** 32 - 4]))
        entries.append(struct.pack(order + "HHI", tag, rng.choice([1, 2, 3, 4, 5]),
                                   rng.choice([0, 1, 2, 4, 5, 20, 1000])) + value)
    count = n if rng.random() < 0.8 else rng.randint(0, 20)
    block = (mark + struct.pack(order + "HI", 42 if rng.random() < 0.95 else 43,
                                8 if rng.random() < 0.9 else rng.choice([0, 4, 100]))
             + struct.pack(order + "H", count) + b"".join(entries) + struct.pack(order + "I", 0)
             + bytes(rng.randrange(256) for _ in range(40)))
    return block[:rng.randint(0, len(block))] if rng.random() < 0.3 else block


def _app1(body):
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("seed", range(3))
def test_jpeg_exif_equals_cv2(seed, progressive):
    rng = random.Random(seed)
    img = np.random.default_rng(seed).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    jpeg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])[1].tobytes()
    plain = _cv2(jpeg)
    sof = jpeg.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    places = [2, jpeg.index(b"\xff\xdb"), sof, jpeg.index(b"\xff\xda")]
    turned = 0
    for _ in range(250):
        segments = b""
        for _ in range(rng.randint(1, 3)):
            prefix = b"Exif\0\0" if rng.random() < 0.85 else \
                rng.choice([b"http://ns.adobe.com/xap/1.0/\0", b"Exif\0\x01"])
            segments += _app1(prefix + _tiff(rng))
        at = rng.choice(places)
        want = _same(jpeg[:at] + segments + jpeg[at:])
        turned += not np.array_equal(want, plain)
    assert turned > 10


@pytest.mark.parametrize("seed", range(3))
def test_png_exif_equals_cv2(seed):
    rng = random.Random(10 + seed)
    img = np.random.default_rng(seed).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    turned = 0
    for _ in range(250):
        chunks = b""
        for _ in range(rng.randint(1, 3)):
            c = _chunk(b"eXIf", _tiff(rng))
            chunks += c[:-1] + b"\0" if rng.random() < 0.1 else c  # a bad CRC
        at = rng.choice([33, png.index(b"IEND") - 4])
        want = _same(png[:at] + chunks + png[at:])
        turned += not np.array_equal(want, img)
    assert turned > 10


@pytest.mark.parametrize("value", range(1, 9))
def test_orientations_turn_as_cv2(value):
    """Each Orientation of a 16x32 image, and ``orient`` on its own."""
    img = np.random.default_rng(value).integers(0, 256, (16, 32, 3), dtype=np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    block = b"II" + struct.pack("<HIH", 42, 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, value, 0) \
        + bytes(4)
    want = _same(png[:33] + _chunk(b"eXIf", block) + png[33:])
    np.testing.assert_array_equal(image.orient(img, value), want)
    assert image.exif_orientation(block) == value


def _bmp(w, h, bits, compression, pixels, palette=b"", masks=b"", header=40, colours=0,
         top_down=False):
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(pixels), 0, 0, colours, 0) + bytes(header - 40)
    offset = 14 + len(info) + len(palette) + len(masks)
    return struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset) + info + palette \
        + masks + pixels


def _rle(rng, w, h, bits):
    """A seeded RLE stream: mostly well-formed lines (runs, absolute runs,
    deltas, ends of line) with an end of bitmap, sometimes random ops."""
    out = bytearray()
    if rng.random() < 0.6:
        for y in range(h):
            x = 0
            while x < w and rng.random() < 0.8:
                n = rng.randint(1, w - x)
                r = rng.random()
                if r < 0.5:
                    out += bytes([n, rng.randrange(256)])
                elif r < 0.8 and n >= 3:
                    data = bytes(rng.randrange(256) for _ in range(n if bits == 8 else (n + 1) // 2))
                    out += bytes([0, n]) + data + (b"\0" if len(data) % 2 else b"")
                else:
                    out += bytes([0, 2, n, 0])
                x += n
            out += b"\0\0"
        out += b"\0\1"
        return bytes(out)
    for _ in range(rng.randint(1, 3 * h + 3)):
        r = rng.random()
        if r < 0.45:
            out += bytes([rng.randint(1, w), rng.randrange(256)])
        elif r < 0.7:
            n = rng.randint(3, max(3, w))
            data = bytes(rng.randrange(256) for _ in range(n if bits == 8 else (n + 1) // 2))
            out += bytes([0, n]) + data + (b"\0" if len(data) % 2 else b"")
        elif r < 0.85:
            out += b"\0\0"
        elif r < 0.95:
            out += bytes([0, 2, rng.randint(0, w), rng.randint(0, 2)])
        else:
            out += b"\0\1"
    return bytes(out + (b"\0\1" if rng.random() < 0.8 else b""))


KINDS = ["1", "4", "8", "rle8", "rle4", "555", "565", "555bf", "32bf", "24", "os2_1", "os2_4",
         "os2_8", "os2_24", "v5_8", "v5_rle8", "8td", "rle8td", "rle4td", "24td"]


@pytest.mark.parametrize("kind", KINDS)
def test_bmp_kinds_equal_cv2(kind):
    rng = random.Random(kind)
    top_down = kind.endswith("td")
    name = kind[:-2] if top_down else kind
    header = 124 if name.startswith("v5") else 12 if name.startswith("os2") else 40
    name = name.split("_")[-1] if header != 40 else name
    bits = {"1": 1, "4": 4, "8": 8, "rle8": 8, "rle4": 4, "555": 16, "565": 16, "555bf": 16,
            "32bf": 32, "24": 24}[name]
    compression = {"rle8": 1, "rle4": 2, "565": 3, "555bf": 3, "32bf": 3}.get(name, 0)
    masks = {"565": (0xF800, 0x7E0, 0x1F), "555bf": (0x7C00, 0x3E0, 0x1F)}.get(name)
    decoded = 0
    for _ in range(120):
        w, h = rng.randint(1, 13), rng.randint(1, 9)
        palette, colours = b"", 0
        if bits <= 8:
            n = 1 << bits
            if header != 12 and rng.random() < 0.3:
                n = colours = rng.randint(1, n)
            palette = bytes(rng.randrange(256) for _ in range(n * (3 if header == 12 else 4)))
        if compression in (1, 2):
            pixels = _rle(rng, w, h, bits)
        else:
            pitch = ((w * bits + 7) // 8 + 3) & ~3
            pixels = bytes(rng.randrange(256) for _ in range(pitch * h))
            if rng.random() < 0.05:
                pixels = pixels[:-1]
        field = b""
        if masks:
            field = struct.pack("<III", *masks)
        elif name == "32bf":
            field = struct.pack("<III", *(rng.choice([0xFF, 0xFF00, 0xFF0000, 0])
                                          for _ in range(3)))
        data = _bmp(w, h, bits, compression, pixels, palette, field, header, colours, top_down)
        first = _cv2(data)
        if first is not None and not np.array_equal(first, _cv2(data)):
            continue  # pixels cv2 left unwritten
        decoded += _same(data) is not None
    assert decoded >= 10


@pytest.mark.parametrize("case,what", [
    ("2-bit", "2-bit BMP"), ("16-bit 4-4-4", "bit fields"), ("os2 16", "OS/2"),
    ("os2 5-bit", "OS/2"), ("20-byte header", "20-byte header"), ("rle8 at 4 bits", "4-bit BMP"),
    ("jpeg", "compression method 4"), ("v4 16-bit fields", "bit fields"),
    ("palette of 300", "palette colours"), ("rle past the line", "RLE"),
    ("rle cut", "truncated")])
def test_unsupported_bmp_kinds_raise_and_name_it(case, what):
    """Kinds cv2 refuses (it returns None) raise a ValueError that names
    what was read."""
    w, h = 5, 3
    pix = bytes(64)
    data = {
        "2-bit": _bmp(w, h, 2, 0, pix, bytes(16)),
        "16-bit 4-4-4": _bmp(w, h, 16, 3, pix, masks=struct.pack("<III", 0xF00, 0xF0, 0xF)),
        "os2 16": _bmp(w, h, 16, 0, pix, header=12),
        "os2 5-bit": _bmp(w, h, 5, 0, pix, bytes(96), header=12),
        "20-byte header": _bmp(w, h, 24, 0, pix)[:14] + struct.pack("<I", 20) + bytes(80),
        "rle8 at 4 bits": _bmp(w, h, 4, 1, b"\0\1", bytes(64)),
        "jpeg": _bmp(w, h, 24, 4, pix),
        "v4 16-bit fields": _bmp(w, h, 16, 3, pix, header=108),
        "palette of 300": _bmp(w, h, 8, 0, pix, bytes(1200), colours=300),
        "rle past the line": _bmp(w, h, 8, 1, b"\x09\x01\0\1", bytes(1024)),
        "rle cut": _bmp(w, h, 8, 1, b"\x02\x01", bytes(1024)),
    }[case]
    assert _cv2(data) is None
    with pytest.raises(ValueError, match=what):
        image.imdecode(data)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_encode_equals_cv2(channels):
    """``imencode('.bmp', img)`` is cv2's file byte for byte: 8-bit gray
    with its gray palette, 24-bit BGR, 32-bit BGRA."""
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (21, 35), (7, 13), (16, 16)):
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        img = img[..., 0].copy() if channels == 1 else img
        want = cv2.imencode(".bmp", img)[1].tobytes()
        assert image.imencode(".bmp", img) == want
        np.testing.assert_array_equal(image.imdecode(want), _cv2(want))
