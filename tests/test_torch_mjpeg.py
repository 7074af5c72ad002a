"""The port's Motion JPEG decoder (``native/mjpeg.cpp`` through
``render/mjpeg.py`` and the readers of ``render/video.py``) against cv2's
``VideoCapture``, which decodes video JPEGs through FFmpeg's ``mjpeg``
decoder, on the CPU.

* Luma: every frame equals cv2's Y plane to the bit (``CAP_PROP_CONVERT_RGB``
  0 returns it), in cv2's count: JPEGs written by ``cv2.imencode`` in each
  sampling (4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1, gray), with restart
  intervals, with their DHT stripped (FFmpeg's standard tables), with an
  ``AVI1`` APP0, and with optimised tables a later frame inherits; each
  muxed by the port into an ``MJPG`` AVI.
* BGR: ``read()`` converts with the full-range matrix and nearest chroma;
  its gap to cv2's BGR (swscale) holds ``BGR_BOUND`` on even-sided 4:2:0,
  4:2:2, 4:4:4 and gray frames and on 4:4:4 at any size (ROADMAP §3
  "Standing bounds"); the limited-range I420 conversion breaks it.  Where
  swscale filters the chroma (odd sides, 4:4:0, 4:1:1) the gap is larger
  and not held (ROADMAP §3).
* Refusals name the tool (progressive, lossless, hierarchical,
  arithmetic, JPEG-LS, 12-bit, RGB, CMYK, other sampling factors,
  interlaced fields, a missing DQT); corrupt and truncated frames raise
  ``ValueError``, and so do seeded mutations, or they decode.
"""
from __future__ import annotations

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.native.draw import i420_to_bgr  # noqa: E402
from adas_tpu_torch.render import avi, mjpeg  # noqa: E402
from adas_tpu_torch.render.video import AVIReader  # noqa: E402

SAMPLINGS = {"420": 0x221111, "422": 0x211111, "444": 0x111111, "440": 0x121111,
             "411": 0x411111, "gray": None}
#: the largest BGR gap to cv2's frames on even-sided 4:2:0, 4:2:2, 4:4:4
#: and gray frames (measured: 2 levels at 64x48 and 720p, 1 on 4:4:4, 0 on
#: gray), where swscale converts without filtering the chroma
BGR_BOUND = 2


def _smooth(n, h, w, seed=1):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 60 * np.sin((x + 3 * t) / 7.0) * np.cos(y / 9.0),
                              128 + 70 * np.cos((x + 3 * t) / 13.0),
                              128 + 80 * np.sin((x - 2 * y + 3 * t) / 11.0)], -1)
                    + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8) for t in range(n)]


def encode(frame, sampling="420", restart=0, quality=90, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if SAMPLINGS[sampling] is None:
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    return cv2.imencode(".jpg", frame, params)[1].tobytes()


def segments(jpeg):
    """(marker, start, end) of each marker segment before the scan data."""
    out, i = [], 2
    while i < len(jpeg):
        m = jpeg[i + 1]
        n = struct.unpack_from(">H", jpeg, i + 2)[0]
        out.append((m, i, i + 2 + n))
        if m == 0xDA:
            break
        i += 2 + n
    return out


def strip(jpeg, marker):
    """The JPEG without its segments of ``marker``."""
    kept = b"".join(jpeg[s:e] for m, s, e in segments(jpeg) if m != marker)
    scan_end = segments(jpeg)[-1][2]
    return jpeg[:2] + kept + jpeg[scan_end:]


def mux(path, frames, width, height, fourcc=b"MJPG"):
    with avi.Muxer(str(path), width, height, fourcc) as m:
        for f in frames:
            m.add(f, True)
    return str(path)


def cv2_frames(path, convert_rgb=False):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 1 if convert_rgb else 0)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def port_frames(path):
    """(Y planes, BGR frames, formats, stats) of the port's reader."""
    ys, bgrs, formats = [], [], []
    with AVIReader(path) as r:
        while (planes := r.read_planes()) is not None:
            ys.append(planes if r._decoder.format == "gray" else planes[0])
            bgrs.append(r._decoder.bgr())
            formats.append(r._decoder.format)
        return ys, bgrs, formats, r.stats()


def assert_luma_equal(path):
    want = cv2_frames(path)
    ys, _, formats, stats = port_frames(path)
    assert len(ys) == len(want) > 0
    for k, (a, b) in enumerate(zip(ys, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    return formats, stats


@pytest.mark.parametrize("variant", ["plain", "restart", "no_dht"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_sampling_and_tools_equal_cv2(tmp_path, sampling, variant):
    """Each sampling, with restart intervals, and with the DHT stripped
    (the decoder's standard tables, as FFmpeg's), at a size that is not a
    multiple of the MCU: cv2's Y planes and count."""
    frames = [encode(f, sampling, restart=3 if variant == "restart" else 0)
              for f in _smooth(3, 37, 53)]
    if variant == "no_dht":
        frames = [strip(f, 0xC4) for f in frames]
        assert all(b"\xff\xc4" not in f[:f.index(b"\xff\xda")] for f in frames)
    formats, stats = assert_luma_equal(mux(tmp_path / "m.avi", frames, 53, 37))
    want = "gray" if sampling == "gray" else f"yuvj{sampling}p"
    assert formats == [want] * 3 and stats["frames"] == 3
    assert (stats["restart_markers"] > 0) == (variant == "restart")
    assert (stats["standard_table_scans"] > 0) == (variant == "no_dht")


def test_avi1_app0_and_inherited_tables_equal_cv2(tmp_path):
    """An ``AVI1`` APP0 (a progressive frame's polarity 0) is read past;
    a frame without DHT after one with optimised tables decodes with those
    tables, which persist as they do in FFmpeg's decoder."""
    f = _smooth(2, 48, 64)
    avi1 = b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + bytes(10)
    plain = encode(f[0])
    frames = [plain[:2] + avi1 + plain[2:]]
    first = encode(f[1], optimize=True)
    second = encode(f[1], optimize=True)
    frames += [first, strip(second, 0xC4)]
    formats, stats = assert_luma_equal(mux(tmp_path / "m.avi", frames, 64, 48))
    assert stats["frames"] == 3 and stats["standard_table_scans"] == 0


def _gaps(path):
    _, bgrs, _, _ = port_frames(path)
    want = cv2_frames(path, convert_rgb=True)
    assert len(bgrs) == len(want)
    return [np.abs(a.astype(int) - b) for a, b in zip(bgrs, want)]


@pytest.mark.parametrize("sampling,hw", [("420", (48, 64)), ("422", (48, 64)),
                                         ("444", (48, 64)), ("gray", (48, 64)),
                                         ("444", (37, 53)), ("gray", (37, 53))])
def test_bgr_within_bound_of_cv2(tmp_path, sampling, hw):
    frames = [encode(f, sampling) for f in _smooth(2, *hw)]
    gaps = _gaps(mux(tmp_path / "m.avi", frames, hw[1], hw[0]))
    assert max(int(g.max()) for g in gaps) <= BGR_BOUND


def test_limited_range_conversion_breaks_the_bound(tmp_path):
    """The same 4:2:0 planes through the I420 (limited-range, cvtColor)
    conversion the other readers use miss cv2's frames by far more than
    ``BGR_BOUND``: the Motion JPEG reader must not take that path."""
    frames = [encode(f, "420") for f in _smooth(2, 48, 64)]
    path = mux(tmp_path / "m.avi", frames, 64, 48)
    want = cv2_frames(path, convert_rgb=True)
    with AVIReader(path) as r:
        y, cb, cr = r.read_planes()
        with pytest.raises(ValueError, match="full-range"):
            r.read_i420()
    limited = i420_to_bgr(np.concatenate([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])
                          .reshape(72, 64), 48, 64)
    assert np.abs(limited.astype(int) - want[0]).max() > 4 * BGR_BOUND


def _sof(jpeg):
    return next(s for m, s, _ in segments(jpeg) if m == 0xC0)


def _with_marker(jpeg, marker):
    i = _sof(jpeg)
    return jpeg[:i + 1] + bytes([marker]) + jpeg[i + 2:]


def _sof_edit(jpeg, offset, value):
    """The JPEG with byte ``offset`` of its SOF payload set."""
    b = bytearray(jpeg)
    b[_sof(jpeg) + 4 + offset] = value
    return bytes(b)


def _decode(frame, container_height=0):
    d = mjpeg.Decoder(container_height)
    try:
        return d.decode(frame)
    finally:
        d.close()


BASE = None


def _base():
    global BASE
    if BASE is None:
        BASE = encode(_smooth(1, 48, 64)[0], "444")
    return BASE


@pytest.mark.parametrize("make,name", [
    (lambda j: _with_marker(j, 0xC2), "progressive"),
    (lambda j: _with_marker(j, 0xC3), "lossless"),
    (lambda j: _with_marker(j, 0xC5), "hierarchical"),
    (lambda j: _with_marker(j, 0xC9), "arithmetic"),
    (lambda j: _with_marker(j, 0xF7), "JPEG-LS"),
    (lambda j: _sof_edit(j, 0, 12), "12-bit"),
    (lambda j: _sof_edit(_sof_edit(_sof_edit(j, 6, ord("R")), 9, ord("G")), 12, ord("B")),
     "RGB"),
    (lambda j: _sof_edit(j, 10, 0x21), "sampling factors"),
    (lambda j: strip(j, 0xDB), "quantisation table"),
])
def test_unsupported_frames_raise_by_name(make, name):
    with pytest.raises(ValueError, match=name):
        _decode(make(_base()))


def test_progressive_cv2_jpeg_and_two_field_frames_raise():
    f = _smooth(1, 48, 64)[0]
    prog = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(ValueError, match="progressive"):
        _decode(prog)
    # a frame of 48 rows in a stream of 96: one field of an interlaced pair
    with pytest.raises(ValueError, match="interlaced"):
        _decode(encode(f), container_height=96)
    assert _decode(encode(f), container_height=48)[0].shape == (48, 64)


def test_cmyk_and_adobe_rgb_raise():
    j = _base()
    i = _sof(j)
    n = struct.unpack_from(">H", j, i + 2)[0]
    sof = bytearray(j[i + 4:i + 2 + n])
    sof[5] = 4
    sof += bytes([4, 0x11, 0])
    cmyk = j[:i] + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + bytes(sof) + j[i + 2 + n:]
    with pytest.raises(ValueError, match="CMYK"):
        _decode(cmyk)
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="Adobe transform 0"):
        _decode(j[:2] + adobe + j[2:])


def test_corrupt_and_truncated_frames_raise():
    j = encode(_smooth(1, 48, 64)[0], "420")
    scan = segments(j)[-1][2]
    with pytest.raises(ValueError, match="truncated"):
        _decode(j[:scan + (len(j) - scan) // 3])
    with pytest.raises(ValueError, match="truncated|corrupt"):
        _decode(j[:segments(j)[1][1] + 5])
    with pytest.raises(ValueError, match="without a frame header"):
        _decode(b"\xff\xd8\xff\xd9")
    bad = bytearray(j)
    bad[scan:scan + 40] = b"\xff\x00" * 20  # all-ones codes: none is in a table
    with pytest.raises(ValueError, match="corrupt"):
        _decode(bytes(bad))
    dht = next(s for m, s, _ in segments(j) if m == 0xC4)
    over = bytearray(j)
    over[dht + 5:dht + 21] = bytes([3]) + bytes(15)  # three codes of one bit
    with pytest.raises(ValueError, match="over-subscribed"):
        _decode(bytes(over))


@pytest.mark.parametrize("sampling", ["420", "422"])
def test_mutated_frames_decode_or_raise_value_error(sampling):
    """Seeded mutations (byte flips, truncations, duplicated runs) of a
    frame decode or raise ``ValueError``; nothing else escapes."""
    j = encode(_smooth(1, 40, 56)[0], sampling, restart=2)
    rng = np.random.default_rng(7)
    d = mjpeg.Decoder()
    outcomes = {"ok": 0, "error": 0}
    for _ in range(300):
        b = bytearray(j)
        kind = rng.integers(3)
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(len(b)))] = int(rng.integers(256))
        elif kind == 1:
            b = b[:int(rng.integers(2, len(b)))]
        else:
            s = int(rng.integers(len(b)))
            b[s:s] = b[s:s + int(rng.integers(1, 64))]
        try:
            d.decode(bytes(b))
            assert d.bgr().shape == (d.height, d.width, 3)
            outcomes["ok"] += 1
        except ValueError:
            outcomes["error"] += 1
            with pytest.raises(ValueError, match="last decode failed"):
                d.bgr()
    d.close()
    assert outcomes["ok"] > 0 and outcomes["error"] > 0
