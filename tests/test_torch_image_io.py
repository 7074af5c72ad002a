"""The port's still-image codec (``adas_tpu_torch/render/image.py`` over
``native/image.cpp``) against ``cv2.imread(path, cv2.IMREAD_COLOR)``.

Bound: equal to the bit, every case.  The committed fixtures
(``tests/data/images``, written by its ``make_fixtures.py``) hold PNGs of
every colour type and bit depth with all five row filters, plain and
Adam7, every BMP kind cv2 reads (24/32-bit both ways up, 1/4/8-bit
palettes, RLE8, RLE4, 16-bit 5-5-5 and 5-6-5, 32-bit bit fields, OS/2 and
V5 headers, cv2's own gray BMP), JPEGs (gray, 4:4:4, 4:2:2, 4:4:0, 4:2:0,
with and without restart intervals, odd sizes, baseline and progressive),
EXIF-oriented JPEGs and PNGs, and 720p frames; each is decoded by the
port and compared with cv2's decode committed beside it (``.npy``, or a
sha256 for the 720p frames), and cv2 is checked against the same files
here.  Further JPEGs (baseline and progressive), PNGs, BMPs and EXIF
blocks are made at random sizes, samplings, qualities, kinds and layouts
during the test, and progressive JPEGs of any legal scan script
(``tests/jpeg_scans.py``); a script that leaves some of the first ten
coefficients unsent or unrefined (libjpeg-turbo smooths those blocks) is
refused by name.  ``imencode`` writes ``cv2.imencode``'s bytes for JPEG
(gray, BGR, BGRA; 1x1 to 720p) and BMP; its PNG reads back through cv2
as written.  Corrupt and truncated files (crafted header segments, and
the fixtures mutated at random from a seed) raise ``ValueError`` and
nothing else.
"""
import glob
import hashlib
import json
import os
import random
import struct

import cv2
import numpy as np
import pytest

import jpeg_scans
from adas_tpu_torch.render import image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images")
FIXTURES = sorted(p for p in glob.glob(os.path.join(DATA, "*"))
                  if p.endswith((".png", ".bmp", ".jpg")) and
                  os.path.exists(os.path.splitext(p)[0] + ".npy"))


def test_fixtures_are_committed():
    kinds = {os.path.basename(p).split("_")[0] for p in FIXTURES}
    assert kinds == {"png", "bmp", "jpg"} and len(FIXTURES) >= 60


@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES])
def test_fixture_equals_cv2(path):
    want = np.load(os.path.splitext(path)[0] + ".npy")
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), want)
    got = image.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["frame_720p.png", "frame_720p_420.jpg",
                                  "frame_720p_prog_exif6.jpg"])
def test_720p_frames_equal_cv2(name):
    with open(os.path.join(DATA, "sha256.json")) as f:
        want = json.load(f)[name]
    got = image.imread(os.path.join(DATA, name))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, cv2.imread(os.path.join(DATA, name)))


def _cv2_jpeg(tmp_path, img, **params):
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img, flags)
    return path


@pytest.mark.parametrize("seed", range(6))
def test_random_jpegs_equal_cv2(tmp_path, seed):
    """cv2's own JPEGs at random sizes, samplings, qualities and restart
    intervals, of noise and of smooth content."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        y, x = np.mgrid[0:h, 0:w]
        smooth = np.stack([x * 3 + y, y * 2 + 50, x + y * 4], -1) % 256
        img = (smooth if rng.random() < 0.5 else rng.integers(0, 256, (h, w, 3))).astype(np.uint8)
        if rng.random() < 0.2:
            img = img[..., 0].copy()
        path = _cv2_jpeg(tmp_path, img, quality=int(rng.integers(5, 101)),
                         sampling_factor=int(rng.choice([0x111111, 0x211111, 0x121111, 0x221111])),
                         rst_interval=int(rng.choice([0, 1, 3, 7])))
        np.testing.assert_array_equal(image.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", ["gray8", "bgr8", "bgra8", "gray16", "bgr16", "bgra16"])
def test_cv2_pngs_equal_cv2(tmp_path, kind):
    """PNGs as cv2 writes them (its own filter choice), 8- and 16-bit."""
    rng = np.random.default_rng(len(kind))
    ch = {"gray": 1, "bgr": 3, "bgra": 4}[kind.rstrip("0123456789")]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, (37, 53, ch)).astype(dtype)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img[..., 0] if ch == 1 else img)
    np.testing.assert_array_equal(image.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


def _scans(data):
    """A progressive JPEG cut into (its segments up to the frame header,
    [each scan: the segments before it, its SOS and its entropy-coded
    data], the EOI)."""
    def seg_end(at):
        return at + 2 + struct.unpack_from(">H", data, at + 2)[0]

    pos = start = seg_end(data.index(b"\xff\xc2"))
    head, parts = data[:pos], []
    while data[pos + 1] != 0xD9:
        is_sos = data[pos + 1] == 0xDA
        pos = seg_end(pos)
        if is_sos:
            while not (data[pos] == 0xFF and data[pos + 1] not in (0x00, *range(0xD0, 0xD8))):
                pos += 1
            parts.append(data[start:pos])
            start = pos
    return head, parts, data[pos:]


def _is_dc_scan(part):
    sos = part.index(b"\xff\xda")
    return part[sos + 5 + 2 * part[sos + 4]] == 0  # Ss


def test_unsupported_jpegs_raise_and_name_it(tmp_path):
    """A baseline file relabelled as arithmetic-coded, lossless or 12-bit,
    and a progressive file cut to its DC scans or without its last
    refinement (libjpeg-turbo smooths such blocks): each refusal names
    what it read.  cv2's progressive file itself decodes as cv2's."""
    prog = os.path.join(DATA, "progressive.jpg")
    np.testing.assert_array_equal(image.imread(prog), cv2.imread(prog, cv2.IMREAD_COLOR))
    with open(prog, "rb") as f:
        head, scans, tail = _scans(f.read())
    dc_only = head + b"".join(s for s in scans if _is_dc_scan(s)) + tail
    no_last = head + b"".join(scans[:-1]) + tail
    for data in (dc_only, no_last):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
        with pytest.raises(ValueError, match="progressive JPEG whose scans leave"):
            image.imdecode(data)
    with open(os.path.join(DATA, "jpg_16x16_444_r0.jpg"), "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc0")
    for marker, what in ((b"\xff\xc9", "arithmetic"), (b"\xff\xc3", "lossless"),
                         (b"\xff\xc5", "hierarchical")):
        with pytest.raises(ValueError, match=what):
            image.imdecode(data[:sof] + marker + data[sof + 2:])
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="8-bit"):
        image.imdecode(twelve)


@pytest.mark.parametrize("seed", range(6))
def test_random_progressive_jpegs_equal_cv2(seed):
    """cv2's progressive JPEGs (its one scan script) at random sizes,
    samplings, qualities and restart intervals, of noise and of smooth
    content."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        y, x = np.mgrid[0:h, 0:w]
        smooth = np.stack([x * 3 + y, y * 2 + 50, x + y * 4], -1) % 256
        img = (smooth if rng.random() < 0.5 else rng.integers(0, 256, (h, w, 3))).astype(np.uint8)
        if rng.random() < 0.2:
            img = img[..., 0].copy()
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 101)),
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 int(rng.choice([0x111111, 0x211111, 0x121111, 0x221111])),
                 cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.choice([0, 1, 3, 7]))]
        data = cv2.imencode(".jpg", img, flags)[1].tobytes()
        np.testing.assert_array_equal(image.imdecode(data),
                                      cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def _would_smooth(script, n):
    """jdcoefct.c smoothing_ok after ``script`` (quantizers nonzero)."""
    bits = jpeg_scans.coef_bits(script, n)
    return bool((bits[:, 0] >= 0).all() and (bits[:, 1:10] != 0).any())


@pytest.mark.parametrize("complete", [True, False], ids=["complete", "incomplete"])
@pytest.mark.parametrize("seed", range(4))
def test_any_scan_script_equals_cv2(seed, complete):
    """Progressive files of random legal scan scripts (successive
    approximation of the DC and of each AC band, interleaved or separate DC
    scans, bands cut anew for refinement, restart intervals) over seeded
    coefficients, gray and every sampling.  cv2 decodes a complete script as
    the baseline file of the same coefficients; the port decodes it as cv2
    does.  A script without one of its last scans decodes as cv2's where
    libjpeg-turbo does not smooth, and is refused by name where it does."""
    rng = np.random.default_rng(200 + seed + 10 * complete)
    outcomes = set()
    for _ in range(12):
        n = 1 if rng.random() < 0.25 else 3
        sampling = [(1, 1)] if n == 1 else \
            [tuple(int(v) for v in rng.choice([[1, 1], [2, 1], [1, 2], [2, 2]])), (1, 1), (1, 1)]
        w, h = (int(v) for v in rng.integers(1, 60, 2))
        coefs = jpeg_scans.random_coefficients(rng, sampling, w, h)
        script = jpeg_scans.random_script(rng, n, complete)
        rst = int(rng.choice([0, 0, 1, 3]))
        prog = jpeg_scans.write(coefs, sampling, w, h, script, rst)
        want = cv2.imdecode(np.frombuffer(prog, np.uint8), cv2.IMREAD_COLOR)
        if complete:
            base = jpeg_scans.write(coefs, sampling, w, h, None, rst)
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(base, np.uint8), cv2.IMREAD_COLOR), want)
            np.testing.assert_array_equal(image.imdecode(base), want)
        if _would_smooth(script, n):
            outcomes.add("refused")
            with pytest.raises(ValueError, match="progressive JPEG whose scans leave"):
                image.imdecode(prog)
        else:
            outcomes.add("equal")
            np.testing.assert_array_equal(image.imdecode(prog), want)
    assert "equal" in outcomes


@pytest.mark.parametrize("content", ["noise", "smooth"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw", [(1, 1), (2, 5), (8, 8), (17, 23), (33, 47), (64, 48), (720, 1280)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_jpeg_encoder_equals_cv2(hw, channels, content):
    """``imencode('.jpg', img)`` is ``cv2.imencode('.jpg', img)`` byte for
    byte: cv2's defaults (quality 95, 4:2:0), gray, BGR and BGRA."""
    h, w = hw
    rng = np.random.default_rng(h * 7 + w + channels)
    if content == "noise":
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    else:
        y, x = np.mgrid[0:h, 0:w]
        img = (np.stack([x * 3 + y, y * 2 + 50, (x + y * 4) // 3, x], -1)[..., :channels] +
               rng.integers(0, 9, (h, w, channels))).astype(np.uint8)
    if channels == 1:
        img = img[..., 0].copy()
    want = cv2.imencode(".jpg", img)[1].tobytes()
    assert image.imencode(".jpg", img) == want
    if channels == 4:  # cv2 drops the alpha
        assert image.imencode(".jpg", img[..., :3]) == want


def test_720p_encode_equals_cv2_digest(tmp_path):
    """The 720p frame's JPEG (BGR and gray) and gray BMP, held to the
    digests of cv2's encode committed beside the fixtures; ``imwrite``
    takes every JPEG suffix cv2 takes."""
    with open(os.path.join(DATA, "encode_sha256.json")) as f:
        want = json.load(f)["frame_720p.png"]
    frame = image.imread(os.path.join(DATA, "frame_720p.png"))
    got = {"jpg": image.imencode(".jpg", frame), "jpg_gray": image.imencode(".jpg", frame[..., 1]),
           "bmp_gray": image.imencode(".bmp", frame[..., 1])}
    assert {k: hashlib.sha256(v).hexdigest() for k, v in got.items()} == want
    for suffix in (".jpg", ".jpeg", ".JPE"):
        path = str(tmp_path / f"x{suffix}")
        assert image.imwrite(path, frame)
        with open(path, "rb") as f:
            assert f.read() == got["jpg"]


def test_missing_or_unknown_reads_none(tmp_path):
    assert image.imread(str(tmp_path / "nothing.png")) is None
    (tmp_path / "x.txt").write_bytes(b"not an image")
    assert image.imread(str(tmp_path / "x.txt")) is None


@pytest.mark.parametrize("suffix", [".png", ".bmp"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_imwrite_reads_back_through_cv2(tmp_path, suffix, channels):
    """What the port writes, cv2 reads as written (gray and BGRA as cv2's
    IMREAD_UNCHANGED gives them); a BMP is cv2's own file byte for byte
    (gray 8-bit paletted, BGRA 32-bit with its bit fields)."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / f"x{suffix}")
    assert image.imwrite(path, img)
    if suffix == ".bmp":
        with open(path, "rb") as f:
            assert f.read() == cv2.imencode(".bmp", img)[1].tobytes()
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(image.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


def test_imwrite_refuses_jpeg_and_other_types(tmp_path):
    """A suffix cv2 writes that the port does not, and an image that is not
    8-bit, raise (a JPEG is written since the encoder was ported)."""
    img = np.zeros((4, 4, 3), np.uint8)
    for suffix in (".tif", ".webp", ".ppm"):
        with pytest.raises(ValueError, match="unsupported image format"):
            image.imwrite(str(tmp_path / f"x{suffix}"), img)
    with pytest.raises(ValueError, match="8-bit"):
        image.imwrite(str(tmp_path / "x.png"), img.astype(np.float32))
    with pytest.raises(ValueError, match="8-bit"):
        image.imwrite(str(tmp_path / "x.jpg"), img.astype(np.uint16))


def _fixture(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _jpeg_segments(data):
    """The marker segments of a JPEG up to and including its first SOS, as
    {marker byte: (offset, length field)} (the first of each marker)."""
    segs, pos = {}, 2
    while True:
        marker, length = data[pos + 1], struct.unpack_from(">H", data, pos + 2)[0]
        segs.setdefault(marker, (pos, length))
        if marker == 0xDA:
            return segs
        pos += 2 + length


# a file with DQT, SOF0, DHT, DRI and SOS segments (restart interval 2)
_RST_JPEG = "jpg_16x16_420_r2.jpg"


@pytest.mark.parametrize("marker,length", [(0xDB, 3), (0xDB, 66), (0xC4, 18), (0xC4, 19),
                                           (0xC0, 8), (0xC0, 16), (0xDA, 3), (0xDA, 8),
                                           (0xDD, 2), (0xE0, 1)])
def test_jpeg_short_segment_raises(marker, length):
    """A segment whose length field is shorter than what it declares
    inside (a DQT's table, a DHT's counts and symbols, a SOF's or SOS's
    components, a DRI's interval), or shorter than its own length field."""
    data = _fixture(_RST_JPEG)
    pos, _ = _jpeg_segments(data)[marker]
    bad = data[:pos + 2] + struct.pack(">H", length) + data[pos + 4:]
    with pytest.raises(ValueError, match="JPEG"):
        image.imdecode(bad)


def test_jpeg_truncated_headers_raise():
    """The file cut anywhere before its entropy-coded data."""
    data = _fixture(_RST_JPEG)
    pos, length = _jpeg_segments(data)[0xDA]
    for cut in range(4, pos + 2 + length):
        with pytest.raises(ValueError, match="JPEG"):
            image.imdecode(data[:cut])


def test_jpeg_over_subscribed_huffman_table_raises():
    """Codes that do not fit their length (jdhuff.c's JERR_BAD_HUFF_TABLE):
    255 codes of length 1, an all-ones code at length 1 or 2, and 255
    codes of length 8 after one of length 1."""
    data = _fixture(_RST_JPEG)
    for counts in ([255] + [0] * 15, [2] + [0] * 15, [1, 2] + [0] * 14, [1] + [0] * 6 + [255] + [0] * 8):
        n = sum(counts)
        dht = (b"\xff\xc4" + struct.pack(">H", 2 + 17 + n) + b"\x00" + bytes(counts)
               + bytes(i % 12 for i in range(n)))
        with pytest.raises(ValueError, match="corrupt JPEG"):
            image.imdecode(data[:2] + dht + data[2:])


def test_jpeg_second_frame_header_raises():
    """A second SOF0, larger than the first (the output is sized from the
    first), and one of the same size."""
    data = _fixture(_RST_JPEG)
    pos, length = _jpeg_segments(data)[0xC0]
    sof = data[pos:pos + 2 + length]
    for h, w in ((512, 512), (16, 16)):
        second = sof[:5] + struct.pack(">HH", h, w) + sof[9:]
        end = pos + 2 + length
        with pytest.raises(ValueError, match="corrupt JPEG"):
            image.imdecode(data[:end] + second + data[end:])


@pytest.mark.parametrize("factors", [0x01, 0x10, 0x00, 0x51, 0x15])
def test_jpeg_bad_sampling_factor_raises(factors):
    """A sampling factor outside 1..4 (0 would divide by zero)."""
    data = _fixture(_RST_JPEG)
    pos, _ = _jpeg_segments(data)[0xC0]
    at = pos + 4 + 7  # the first component's h/v byte
    for comp in range(3):
        bad = data[:at + 3 * comp] + bytes([factors]) + data[at + 3 * comp + 1:]
        with pytest.raises(ValueError, match="corrupt JPEG"):
            image.imdecode(bad)


def test_jpeg_bad_frame_and_scan_fields_raise():
    """A zero height, an undefined quantization table, and a scan of no
    components or of more than the frame has."""
    data = _fixture(_RST_JPEG)
    sof, _ = _jpeg_segments(data)[0xC0]
    sos, _ = _jpeg_segments(data)[0xDA]
    cases = [data[:sof + 5] + b"\x00\x00" + data[sof + 7:],
             data[:sof + 12] + b"\x03" + data[sof + 13:],
             data[:sos + 4] + b"\x00" + data[sos + 5:],
             data[:sos + 4] + b"\x04" + data[sos + 5:]]
    for bad in cases:
        with pytest.raises(ValueError, match="JPEG"):
            image.imdecode(bad)


def test_png_and_bmp_corrupt_raise():
    png = _fixture("png_c2_d8_i0.png")
    ihdr = png[8:8 + 25]
    huge = ihdr[:8] + struct.pack(">II", 1 << 16, 1 << 15) + ihdr[16:]
    cases = [png[:8] + struct.pack(">I", 12) + png[12:],  # a 12-byte IHDR
             png[:8] + huge + png[33:],  # 2^31 pixels
             png[:40] + bytes(len(png) - 40)]  # the IDAT zeroed
    for bad in cases:
        with pytest.raises(ValueError, match="PNG"):
            image.imdecode(bad)
    bmp = _fixture("bmp_24_bu.bmp")
    for bad in (bmp[:30], bmp[:-10], bmp[:18] + struct.pack("<i", 0) + bmp[22:]):
        with pytest.raises(ValueError, match="BMP"):
            image.imdecode(bad)


#: the fixtures each mutation case draws from
MUTATED = {
    "jpg": lambda n: n.startswith("jpg"),
    "png": lambda n: n.startswith("png"),
    "bmp": lambda n: n.startswith("bmp"),
    "progressive": lambda n: "_prog" in n,
    "exif": lambda n: "_exif_" in n,
    "bmp_kinds": lambda n: n.startswith("bmp") and not n.startswith(("bmp_24", "bmp_32_bu",
                                                                       "bmp_32_td")),
}


@pytest.mark.parametrize("kind", list(MUTATED))
def test_mutated_fixtures_decode_or_raise_value_error(kind):
    """Fixtures with random bytes changed, cut, dropped or inserted: each
    decodes to an (H, W, 3) uint8 image or raises ValueError."""
    files = [p for p in FIXTURES if MUTATED[kind](os.path.basename(p))]
    assert len(files) >= 8
    rng = random.Random(kind)
    for _ in range(600):
        data = bytearray(_fixture(rng.choice(files)))
        for _ in range(rng.randint(1, 8)):
            pos, r = rng.randrange(len(data)), rng.random()
            if r < 0.6:
                data[pos] = rng.randrange(256)
            elif r < 0.8:
                del data[pos:pos + rng.randint(1, 40)]
            else:
                data[pos:pos] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 20)))
        if rng.random() < 0.2:
            data = data[:rng.randrange(2, len(data) + 1)]
        try:
            out = image.imdecode(bytes(data))
        except ValueError:
            continue
        assert out is None or (out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3)
