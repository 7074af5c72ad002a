"""Writes the image codec's fixtures beside this file and their
``cv2.imread(path, cv2.IMREAD_COLOR)`` decodes (``<name>.npy``; for the
720p files the decode's sha256 in ``sha256.json``).  Needs cv2; run from
the repository root:

    python tests/data/images/make_fixtures.py

PNGs of every colour type and bit depth, each row filter, Adam7 (written
by ``png_bytes`` below, since cv2 cannot write them); 24- and 32-bit
BMPs, bottom-up and top-down; JPEGs by cv2: gray, 4:4:4, 4:2:2, 4:4:0 and
4:2:0, with and without restart intervals, at odd sizes, baseline and
progressive (``IMWRITE_JPEG_PROGRESSIVE``: ``jpg_*_prog_*``); a 720p PNG
and 720p 4:2:0 and 4:2:2 JPEGs (the latter two also the frames of the
Motion JPEG clip of ``tests/data/video/avi_clips.py``).

The BMP kinds cv2 reads (``bmp_bytes`` / ``rle8`` / ``rle4`` below, and
cv2's own 8-bit gray BMP): 1-, 4- and 8-bit palettes (a short one too),
RLE8 and RLE4 with ends of line, deltas and an end of bitmap, 16-bit
5-5-5 and 5-6-5, 32-bit bit fields with masks cv2 ignores, OS/2's 12-byte
header, a 124-byte (V5) header, top-down.

EXIF orientation (``exif_jpeg`` / ``exif_png`` below): cv2's 16x32 JPEG
with an ``Exif`` APP1 for each Orientation 1-8 (little- and big-endian),
progressive, after the DQT, behind an XMP APP1, truncated before the
value, with a count of 0, with a value of 9, and a PNG with ``eXIf`` before
and after its IDAT; and ``frame_720p_prog_exif6.jpg``: the 720p frame
stored turned a quarter left, progressive, with Orientation 6 (cv2 reads
it upright), its decode's sha256 in ``sha256.json``.

``encode_sha256.json``: the sha256 of ``cv2.imencode`` of the 720p frame's
pixels as ``.jpg`` (BGR and its green plane as gray) and of the gray plane
as ``.bmp``.
"""
import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def filter_rows(raw, rowbytes, bpp, filters):
    """Filter rows of bytes, row i with filters[i % len(filters)]."""
    out, prev = bytearray(), bytes(rowbytes)
    for i in range(len(raw) // rowbytes):
        row = raw[i * rowbytes:(i + 1) * rowbytes]
        f = filters[i % len(filters)]
        enc = bytearray(rowbytes)
        for x in range(rowbytes):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, paeth(a, b, c))[f]
            enc[x] = (row[x] - pred) & 0xFF
        out += bytes([f]) + enc
        prev = row
    return bytes(out)


def pack_rows(samples, depth):
    """(h, w*ch) integer samples -> (row bytes, bytes per row) at ``depth``
    bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").tobytes(), samples.shape[1] * 2
    if depth == 8:
        return samples.astype(np.uint8).tobytes(), samples.shape[1]
    per = 8 // depth
    w = samples.shape[1]
    rowbytes = (w * depth + 7) // 8
    out = np.zeros((h, rowbytes), np.uint8)
    for x in range(w):
        out[:, x // per] |= (samples[:, x].astype(np.uint8) << (8 - depth - (x % per) * depth))
    return out.tobytes(), rowbytes


def png_bytes(samples, color_type, depth, filters=(0,), interlace=0, palette=None):
    """A PNG of ``samples`` (h, w, ch) at ``depth``."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2))
        data = b""
        for x0, y0, dx, dy in passes:
            sub = samples[y0::dy, x0::dx]
            if sub.size == 0:
                continue
            raw, rowbytes = pack_rows(sub.reshape(sub.shape[0], -1), depth)
            data += filter_rows(raw, rowbytes, bpp, filters)
    else:
        raw, rowbytes = pack_rows(samples.reshape(h, -1), depth)
        data = filter_rows(raw, rowbytes, bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                           color_type, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


def bmp_bytes(bgr, bits, top_down=False):
    h, w = bgr.shape[:2]
    px = bgr if bits == 24 else np.concatenate([bgr, np.full((h, w, 1), 77, np.uint8)], axis=2)
    nb = bits // 8
    stride = (w * nb + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * nb] = (px if top_down else px[::-1]).reshape(h, -1)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, rows.size,
                       2835, 2835, 0, 0)
    return header + info + rows.tobytes()


def bmp_file(w, h, bits, compression, pixels, palette=None, masks=None, header=40,
             colours=0, top_down=False):
    """A BMP of raw ``pixels``: a ``header``-byte info header (12: OS/2,
    with a 3-byte palette), the palette (B, G, R[, 0]) or the masks after
    it."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        table = b"" if palette is None else np.asarray(palette, np.uint8)[:, :3].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(pixels), 2835, 2835, colours, 0)
        info += bytes(header - 40)
        table = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    if masks is not None:
        table += struct.pack("<III", *masks)
    offset = 14 + len(info) + len(table)
    return struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset) + info + table \
        + pixels


def pack_indices(idx, bits):
    """(h, w) palette indices -> bottom-up BMP rows at ``bits`` per pixel."""
    h, w = idx.shape
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    per = 8 // bits
    for x in range(w):
        rows[:, x // per] |= (idx[::-1, x].astype(np.uint8) << (8 - bits - (x % per) * bits))
    return rows.tobytes()


def rle8(lines):
    """RLE8 of lines of ops: ("run", n, index), ("abs", [indices]),
    ("delta", dx, dy); each line ends with an end of line, the last with an
    end of bitmap."""
    out = bytearray()
    for i, ops in enumerate(lines):
        for op in ops:
            if op[0] == "run":
                out += bytes([op[1], op[2]])
            elif op[0] == "abs":
                out += bytes([0, len(op[1])]) + bytes(op[1]) + (b"\0" if len(op[1]) % 2 else b"")
            else:
                out += bytes([0, 2, op[1], op[2]])
        out += b"\0\1" if i == len(lines) - 1 else b"\0\0"
    return bytes(out)


def rle4(lines):
    """RLE4 of lines of ops: ("run", n, hi, lo) alternating two indices,
    ("abs", [indices]), ("delta", dx, dy); an end of line after each line
    (an RLE4 end of bitmap ends only its line, in OpenCV)."""
    out = bytearray()
    for ops in lines:
        for op in ops:
            if op[0] == "run":
                out += bytes([op[1], (op[2] << 4) | op[3]])
            elif op[0] == "abs":
                v = list(op[1]) + [0] * (len(op[1]) % 2)
                packed = bytes((v[j] << 4) | v[j + 1] for j in range(0, len(v), 2))
                out += bytes([0, len(op[1])]) + packed + (b"\0" if len(packed) % 2 else b"")
            else:
                out += bytes([0, 2, op[1], op[2]])
        out += b"\0\0"
    return bytes(out)


def bmp_kinds(rng):
    """The BMP kinds of cv2's BmpDecoder, by fixture name."""
    w, h = 13, 7
    pal = lambda n: np.concatenate([rng.integers(0, 256, (n, 3)), np.zeros((n, 1), int)], 1)
    out = {}
    for bits in (1, 4, 8):
        idx = rng.integers(0, 1 << bits, (h, w))
        out[f"bmp_{bits}_pal.bmp"] = bmp_file(w, h, bits, 0, pack_indices(idx, bits),
                                              pal(1 << bits))
    idx = rng.integers(0, 40, (h, w))  # indices past the 20 colours read black
    out["bmp_8_short_pal.bmp"] = bmp_file(w, h, 8, 0, pack_indices(idx, 8), pal(20), colours=20)
    rows = pack_indices(rng.integers(0, 256, (h, w)), 8)
    top = np.frombuffer(rows, np.uint8).reshape(h, -1)[::-1].tobytes()
    out["bmp_8_pal_td.bmp"] = bmp_file(w, h, 8, 0, top, pal(256), top_down=True)
    out["bmp_8_pal_v5.bmp"] = bmp_file(w, h, 8, 0, rows, pal(256), header=124)
    out["bmp_8_os2.bmp"] = bmp_file(w, h, 8, 0, rows, pal(256), header=12)
    out["bmp_4_os2.bmp"] = bmp_file(w, h, 4, 0, pack_indices(rng.integers(0, 16, (h, w)), 4),
                                    pal(16), header=12)
    stride24 = (w * 3 + 3) & ~3
    out["bmp_24_os2.bmp"] = bmp_file(w, h, 24, 0,
                                     rng.integers(0, 256, h * stride24, dtype=np.uint8).tobytes(),
                                     header=12)
    lines8 = [[("run", 5, 3), ("abs", [7, 8, 9, 10]), ("run", 4, 200)],
              [("run", 13, 17)],
              [("abs", [1, 2, 3]), ("delta", 2, 1), ("run", 3, 9)],
              [("run", 2, 250), ("abs", [4, 5, 6, 7, 8])],
              [("delta", 6, 0), ("run", 7, 33)]]
    out["bmp_8_rle.bmp"] = bmp_file(w, h, 8, 1, rle8(lines8), pal(256))
    lines4 = [[("run", 5, 3, 12), ("abs", [7, 8, 9, 10, 11]), ("run", 3, 1, 2)],
              [("run", 13, 4, 5)],
              [("abs", [1, 2, 3]), ("delta", 2, 1), ("run", 3, 9, 0)],
              [("run", 2, 15, 14)], [("delta", 6, 0), ("run", 7, 6, 7)], [], [("run", 1, 2, 2)]]
    out["bmp_4_rle.bmp"] = bmp_file(w, h, 4, 2, rle4(lines4), pal(16))
    t = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    stride16 = (w * 2 + 3) & ~3
    rows16 = np.zeros((h, stride16), np.uint8)
    rows16[:, :w * 2] = t[::-1].view(np.uint8).reshape(h, -1)
    out["bmp_16_555.bmp"] = bmp_file(w, h, 16, 0, rows16.tobytes())
    out["bmp_16_555_bf.bmp"] = bmp_file(w, h, 16, 3, rows16.tobytes(),
                                        masks=(0x7C00, 0x3E0, 0x1F))
    out["bmp_16_565.bmp"] = bmp_file(w, h, 16, 3, rows16.tobytes(), masks=(0xF800, 0x7E0, 0x1F))
    px = rng.integers(0, 256, (h, w * 4), dtype=np.uint8).tobytes()
    out["bmp_32_bf_rgba.bmp"] = bmp_file(w, h, 32, 3, px, masks=(0xFF, 0xFF00, 0xFF0000))
    return out


def tiff_orientation(value, big_endian=False, count=1):
    """A TIFF block with IFD0 = one Orientation entry."""
    bo = ">" if big_endian else "<"
    entry = struct.pack(bo + "HHI", 0x0112, 3, count) + struct.pack(bo + "HH", value, 0)
    return (b"MM" if big_endian else b"II") + struct.pack(bo + "HI", 42, 8) + \
        struct.pack(bo + "H", 1) + entry + struct.pack(bo + "I", 0)


def app1(body):
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def exif_jpeg(jpeg, tiff, before=b"\xff\xdb"):
    """``jpeg`` with an Exif APP1 of ``tiff`` before its first ``before``
    marker."""
    at = jpeg.index(before)
    return jpeg[:at] + app1(b"Exif\0\0" + tiff) + jpeg[at:]


def exif_png(png, tiff, after_idat=False):
    at = png.index(b"IEND") - 4 if after_idat else 33
    return png[:at] + chunk(b"eXIf", tiff) + png[at:]


def smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 7 + y * 3) % 256, (y * 5 + 40) % 256, (x * 2 + y * 9) // 3 % 256], -1)
    return np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def road_frame():
    """A 720p frame of gradients and two lane-like strokes (compresses
    well, unlike noise)."""
    y, x = np.mgrid[0:720, 0:1280]
    frame = np.stack([x * 255 // 1279, y * 255 // 719, (x + y) * 255 // 1998], -1)
    frame = frame.astype(np.uint8)
    frame[(np.abs(x - 640 - (y - 360) * 0.8) < 6) | (np.abs(x - 640 + (y - 360) * 0.8) < 6)] = 230
    return frame


def main():
    import cv2

    rng = np.random.default_rng(0)
    files = {}
    h, w = 13, 19
    for ct, ch in ((0, 1), (2, 3), (3, 1), (4, 2), (6, 4)):
        for depth in ((1, 2, 4, 8, 16) if ct == 0 else (1, 2, 4, 8) if ct == 3 else (8, 16)):
            for interlace in (0, 1):
                top = (1 << depth) - 1
                samples = rng.integers(0, top + 1, (h, w, ch))
                palette = rng.integers(0, 256, (min(1 << depth, 256), 3)) if ct == 3 else None
                name = f"png_c{ct}_d{depth}_i{interlace}.png"
                files[name] = png_bytes(samples, ct, depth, filters=(0, 1, 2, 3, 4),
                                        interlace=interlace, palette=palette)
    for bits in (24, 32):
        for top_down in (False, True):
            files[f"bmp_{bits}_{'td' if top_down else 'bu'}.bmp"] = bmp_bytes(
                smooth(11, 17, bits), bits, top_down)
    for path, data in files.items():
        with open(os.path.join(HERE, path), "wb") as f:
            f.write(data)
    samplings = {"444": 0x111111, "422": 0x211111, "440": 0x121111, "420": 0x221111}
    for (jh, jw) in ((16, 16), (21, 35), (9, 3)):
        img = smooth(jh, jw, jh)
        for name, sf in samplings.items():
            for rst in (0, 2):
                path = f"jpg_{jh}x{jw}_{name}_r{rst}.jpg"
                cv2.imwrite(os.path.join(HERE, path), img,
                            [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf,
                             cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
                files[path] = None
        path = f"jpg_{jh}x{jw}_gray.jpg"
        cv2.imwrite(os.path.join(HERE, path), img[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 80])
        files[path] = None
    for name in files:
        decoded = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_COLOR)
        np.save(os.path.join(HERE, os.path.splitext(name)[0] + ".npy"), decoded)
    cv2.imwrite(os.path.join(HERE, "progressive.jpg"), smooth(16, 16, 1),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    progressive = {}
    for (jh, jw) in ((21, 35), (9, 3)):
        img = smooth(jh, jw, jh + 100)
        for name, sf in samplings.items():
            for rst in (0, 2):
                progressive[f"jpg_{jh}x{jw}_{name}_prog_r{rst}.jpg"] = cv2.imencode(
                    ".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 80,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf,
                                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes()
        progressive[f"jpg_{jh}x{jw}_gray_prog.jpg"] = cv2.imencode(
            ".jpg", img[..., 1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    base = cv2.imencode(".jpg", smooth(16, 32, 5))[1].tobytes()
    prog = cv2.imencode(".jpg", smooth(16, 32, 5), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    exif = {}
    for value in range(1, 9):
        exif[f"jpg_exif_o{value}.jpg"] = exif_jpeg(base, tiff_orientation(value, value % 2 == 0))
    xmp = app1(b"http://ns.adobe.com/xap/1.0/\0<x:xmpmeta/>")
    exif.update({
        "jpg_exif_o6_prog.jpg": exif_jpeg(prog, tiff_orientation(6)),
        "jpg_exif_o6_after_dqt.jpg": exif_jpeg(base, tiff_orientation(6), b"\xff\xc0"),
        "jpg_exif_o6_behind_xmp.jpg": base[:2] + xmp + exif_jpeg(base, tiff_orientation(6))[2:],
        "jpg_exif_o6_truncated.jpg": exif_jpeg(base, tiff_orientation(6)[:19]),
        "jpg_exif_o6_count0.jpg": exif_jpeg(base, tiff_orientation(6, count=0)),
        "jpg_exif_o9.jpg": exif_jpeg(base, tiff_orientation(9)),
    })
    png = cv2.imencode(".png", smooth(16, 32, 6))[1].tobytes()
    for value in (3, 6, 8):
        exif[f"png_exif_o{value}.png"] = exif_png(png, tiff_orientation(value, value == 8))
    exif["png_exif_o5_after_idat.png"] = exif_png(png, tiff_orientation(5), after_idat=True)
    written = {**progressive, **exif, **bmp_kinds(np.random.default_rng(8))}
    for name, data in written.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    gray = smooth(21, 35, 9)[..., 0]
    assert cv2.imwrite(os.path.join(HERE, "bmp_8_gray.bmp"), gray)  # cv2's own gray BMP
    for name in list(written) + ["bmp_8_gray.bmp"]:
        decoded = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_COLOR)
        assert decoded is not None, name
        np.save(os.path.join(HERE, os.path.splitext(name)[0] + ".npy"), decoded)
    frame = road_frame()
    cv2.imwrite(os.path.join(HERE, "frame_720p.png"), frame, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    cv2.imwrite(os.path.join(HERE, "frame_720p_420.jpg"), frame,
                [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 40])
    cv2.imwrite(os.path.join(HERE, "frame_720p_422.jpg"), frame,
                [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 40])
    # stored a quarter turn left: Orientation 6 turns it back upright
    stored = cv2.imencode(".jpg", np.ascontiguousarray(np.rot90(frame)),
                          [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85])[1]
    with open(os.path.join(HERE, "frame_720p_prog_exif6.jpg"), "wb") as f:
        f.write(exif_jpeg(stored.tobytes(), tiff_orientation(6)))
    digests = {}
    for name in ("frame_720p.png", "frame_720p_420.jpg", "frame_720p_422.jpg",
                 "frame_720p_prog_exif6.jpg"):
        decoded = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_COLOR)
        digests[name] = {"shape": list(decoded.shape),
                         "sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    encoded = {"jpg": cv2.imencode(".jpg", frame)[1], "jpg_gray": cv2.imencode(".jpg", frame[..., 1])[1],
               "bmp_gray": cv2.imencode(".bmp", frame[..., 1])[1]}
    with open(os.path.join(HERE, "encode_sha256.json"), "w") as f:
        json.dump({"frame_720p.png": {k: hashlib.sha256(v.tobytes()).hexdigest()
                                      for k, v in encoded.items()}}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
