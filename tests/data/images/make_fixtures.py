"""Writes the image codec's fixtures beside this file and their
``cv2.imread(path, cv2.IMREAD_COLOR)`` decodes (``<name>.npy``; for the
720p files the decode's sha256 in ``sha256.json``).  Needs cv2; run from
the repository root:

    python tests/data/images/make_fixtures.py

PNGs of every colour type and bit depth, each row filter, Adam7 (written
by ``png_bytes`` below, since cv2 cannot write them); 24- and 32-bit
BMPs, bottom-up and top-down; JPEGs by cv2: gray, 4:4:4, 4:2:2, 4:4:0 and
4:2:0, with and without restart intervals, at odd sizes; a progressive
JPEG (which the port refuses); a 720p PNG and 720p 4:2:0 and 4:2:2 JPEGs
(the latter two also the frames of the Motion JPEG clip of
``tests/data/video/avi_clips.py``).
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
    frame = road_frame()
    cv2.imwrite(os.path.join(HERE, "frame_720p.png"), frame, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    cv2.imwrite(os.path.join(HERE, "frame_720p_420.jpg"), frame,
                [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 40])
    cv2.imwrite(os.path.join(HERE, "frame_720p_422.jpg"), frame,
                [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 40])
    digests = {}
    for name in ("frame_720p.png", "frame_720p_420.jpg", "frame_720p_422.jpg"):
        decoded = cv2.imread(os.path.join(HERE, name), cv2.IMREAD_COLOR)
        digests[name] = {"shape": list(decoded.shape),
                         "sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
