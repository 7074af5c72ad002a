"""MPEG-4 Part 2 Advanced Simple video (``native/mpeg4.cpp`` through
``render/mpeg4.py`` and the AVI / MP4 readers) against cv2's decode, on
the CPU.

cv2's writer uses none of these tools, so the streams come from the
seeded writer ``tests/data/video/mpeg4_writer.py`` (random legal syntax,
and a content clip), muxed by the port's own AVI and MP4 muxers; cv2 is
the judge (``CAP_PROP_CONVERT_RGB`` 0 returns the decoded Y plane).

* Every tool alone and XviD's combination (B-VOPs + 4MV + quarter-sample
  + MPEG matrices), each under the user data of Lavc, an XviD build (64,
  and 1 with its workarounds), DivX 5.03 (one B-VOP at a time: packed) and
  none (an ``XVID`` tag alone: XviD build 0), in AVI and MP4, give cv2's Y
  to the bit in cv2's count and order.
* The committed fixtures (``tests/data/video/mpeg4``, ``make_fixtures.py
  mpeg4``: each admitted only where FFmpeg logs no error) decode to cv2's
  digests; the decoder's counters show each uses the tools it claims.
* Chroma, which cv2 gives only through swscale's BGR: every fixture's is
  FFmpeg's to the bit through the I_PCM carrier of ``test_torch_h264.py``
  (cv2's BGR of the fixture against cv2's BGR of the port's planes as
  lossless H.264), and content clips with every tool, under each user
  data, stay within the drift bound of ``test_torch_mpeg4.py``.
* The XviD IDCT: a stream with XviD's user data decodes through it, as
  libavcodec's does, and the same stream under Lavc's user data through
  the simple IDCT; cv2's Y differs between the two and the port matches
  both.
* Seeded mutations of the fixtures decode or raise ``ValueError``.
* The 720p content clip (``mpeg4_writer.content_720p``) decodes to cv2's
  digests.
* Interlace (field DCT, field vectors and selects in P- and B-VOPs, field
  direct, the alternate vertical scan; XviD's XVIX and old Lavc's edge
  workarounds): cv2 returns blank frames for these streams, so the
  interlaced fixtures are held to the Y, U and V planes that cv2's bundled
  libavcodec decodes (digests committed by ``make_fixtures.py mpeg4``), in
  cv2's count.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.native.draw import i420_to_bgr  # noqa: E402
from adas_tpu_torch.render import mpeg4  # noqa: E402
from adas_tpu_torch.render.video import AVIReader, MP4Reader  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
ASP_DATA = os.path.join(DATA, "mpeg4")
sys.path.insert(0, DATA)
import mpeg4_writer  # noqa: E402

with open(os.path.join(ASP_DATA, "sha256.json")) as _f:
    DIGESTS = json.load(_f)
#: the fixtures cv2 judges, and the interlaced ones, whose frames cv2 5.0
#: on FFmpeg 8.1 returns blank (its sws_scale refuses an interlaced frame):
#: held to the planes of cv2's bundled libavcodec (``make_fixtures.py``)
FIXTURES = [n for n, v in DIGESTS.items() if n != "content_720p" and "reference" not in v]
INTERLACED = [n for n, v in DIGESTS.items() if v.get("reference") == "libavcodec"]


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def port_decode(path):
    """The port's (Y planes, I420 planes, stats) of a file, in order."""
    reader = AVIReader if path.endswith(".avi") else MP4Reader
    planes = []
    with reader(path) as r:
        while (p := r.read_planes()) is not None:
            planes.append(p)
        return [p[:r.height] for p in planes], planes, r.stats()


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


def assert_cv2s(path):
    ys, _, stats = port_decode(path)
    want = cv2_frames(path)
    assert len(ys) == len(want), (os.path.basename(path), len(ys), len(want))
    for i, (got, ref) in enumerate(zip(ys, want)):
        np.testing.assert_array_equal(got, ref, err_msg=f"{os.path.basename(path)} frame {i}")
    return stats


# ------------------------------------------------------- tools against cv2

#: each tool alone, and combined as XviD's presets combine them
TOOLS = {
    "4mv": {"four_mv": 60},
    "qpel": {"qpel": 1},
    "qpel_4mv": {"qpel": 1, "four_mv": 60},
    "mpeg_quant": {"mpeg_quant": 1},
    "matrices": {"mpeg_quant": 2},
    "b1": {"bframes": 1},
    "b3_4mv": {"bframes": 3, "four_mv": 40},
    "packets": {"packets": 15, "hec": 40},
    "xvid_preset": mpeg4_writer.XVID_PRESET,
    "preset_packets": {**mpeg4_writer.XVID_PRESET, "mpeg_quant": 2, "packets": 12, "hec": 30},
}
#: the user data kinds: writer options and the AVI fourcc
USERS = {
    "lavc": ({"user": mpeg4_writer.LAVC}, b"XVID"),
    "xvid": ({"user": mpeg4_writer.XVID, "build": 64}, b"XVID"),
    "xvid1": ({"user": mpeg4_writer.XVID, "build": 1}, b"XVID"),
    "divx": ({"user": mpeg4_writer.DIVX, "build": 1393}, b"DX50"),
    "tag": ({"user": mpeg4_writer.NO_USER_DATA}, b"XVID"),
}
#: what each tool makes the decoder count
CLAIMS = {
    "four_mv": "inter4v_mbs", "qpel": "qpel_vops", "mpeg_quant": "mpeg_quant_vops",
    "bframes": "b_vops", "packets": "video_packets", "hec": "hec_packets",
}


@pytest.mark.parametrize("user", list(USERS))
@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_gives_cv2s_luma(tmp_path, tool, user):
    """Two seeds, 72x40 (not a multiple of 16) and 64x48, each in an AVI
    and an MP4: the port's Y planes are cv2's, in cv2's count and order,
    and the decoder counted every tool the stream claims."""
    options, fourcc = USERS[user]
    for seed, (w, h) in enumerate(((72, 40), (64, 48))):
        stream = mpeg4_writer.exercise(seed=seed, width=w, height=h, frames=7,
                                       **TOOLS[tool], **options)
        avi_path, mp4_path = str(tmp_path / f"{seed}.avi"), str(tmp_path / f"{seed}.mp4")
        mpeg4_writer.to_avi(stream, avi_path, fourcc)
        mpeg4_writer.to_mp4(stream, mp4_path)
        for path in (avi_path, mp4_path):
            stats = assert_cv2s(path)
            for opt, counter in CLAIMS.items():
                if {**TOOLS[tool]}.get(opt):
                    assert stats[counter] > 0, (tool, user, counter, stats)
            if user in ("xvid", "xvid1") or (user == "tag" and path.endswith(".avi")):
                assert stats["xvid_idct_vops"] == stats["i_vops"] + stats["p_vops"] + \
                    stats["b_vops"]
            else:
                assert stats["xvid_idct_vops"] == 0
            if user == "divx" and TOOLS[tool].get("bframes") == 1:
                assert stats["packed_b_vops"] == stats["b_vops"] > 0


def test_xvid_idct_is_the_one_cv2_picks(tmp_path):
    """One stream's macroblocks under XviD's and under Lavc's user data:
    cv2 decodes them through different IDCTs (its Y differs), and the port
    gives each one's Y to the bit."""
    ys = {}
    for user in (mpeg4_writer.XVID, mpeg4_writer.LAVC):
        stream = mpeg4_writer.exercise(seed=7, width=64, height=48, frames=4, user=user,
                                       big_levels=20)
        path = str(tmp_path / f"{user}.avi")
        mpeg4_writer.to_avi(stream, path, b"XVID")
        assert_cv2s(path)
        ys[user] = cv2_frames(path)
    assert any(not np.array_equal(a, b) for a, b in zip(ys[mpeg4_writer.XVID],
                                                        ys[mpeg4_writer.LAVC]))


def test_n_vops_and_the_stream_end(tmp_path):
    """N-VOPs give no frame, one at the stream's end included, in a low
    delay stream and as DivX's placeholders; the count is cv2's."""
    for options, fourcc in (({"nvop": 60, "frames": 9}, b"XVID"),
                            ({"user": mpeg4_writer.DIVX, "bframes": 1, "frames": 8}, b"DX50")):
        for seed in range(3):
            stream = mpeg4_writer.exercise(seed=seed, **options)
            path = str(tmp_path / f"{seed}.avi")
            mpeg4_writer.to_avi(stream, path, fourcc)
            stats = assert_cv2s(path)
            assert stats["n_vops"] or stats["packed_b_vops"]


# ------------------------------------------------------------------ fixtures

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_gives_cv2s_digests(name):
    path = os.path.join(ASP_DATA, name)
    ys, _, _ = port_decode(path)
    want = DIGESTS[name]
    assert len(ys) == want["frames"]
    assert ys[0].shape == (want["height"], want["width"])
    assert [_sha(y) for y in ys] == want["y_sha256"]
    assert_cv2s(path)


#: content clips' user data: XviD (64, and 1 with its quarter-sample chroma
#: workaround), Lavc, DivX 5.03 build 1393 (packed, its chroma workarounds)
CONTENT_USERS = {
    "xvid": ({"user": mpeg4_writer.XVID, "build": 64, "bframes": 2}, b"XVID"),
    "xvid1": ({"user": mpeg4_writer.XVID, "build": 1, "bframes": 2}, b"XVID"),
    "lavc": ({"user": mpeg4_writer.LAVC, "bframes": 3}, b"XVID"),
    "divx": ({"user": mpeg4_writer.DIVX, "build": 1393, "bframes": 1}, b"DX50"),
}


@pytest.fixture(scope="module")
def small_frames():
    """A pan over ``frame_720p.png`` scaled to 176x144, 8 frames."""
    img = mpeg4_writer.frame_720p()
    y = cv2.resize(img[:720], (176, 144), interpolation=cv2.INTER_AREA)
    c = [cv2.resize(img[720:].reshape(2, 360, 640)[k], (88, 72), interpolation=cv2.INTER_AREA)
         for k in range(2)]
    planes = np.concatenate([y.ravel(), c[0].ravel(), c[1].ravel()]).reshape(216, 176)
    return mpeg4_writer.pan_frames(planes, 8, (7, 3))


@pytest.mark.parametrize("user", list(CONTENT_USERS))
def test_content_chroma_does_not_drift_from_cv2s(tmp_path, small_frames, user):
    """A content clip (B-VOPs, 4MV, quarter-sample vectors, MPEG
    quantisation) under each user data, in an AVI and an MP4: Y to the
    bit, and the 99th percentile of the BGR gap to cv2's frame (swscale)
    within 1 level of the gap on the intra frame, the bound of
    ``test_torch_mpeg4.py`` (measured: 1-2 levels on every frame).  Random
    syntax has no such bound: swscale's chroma filter departs from the
    nearest chroma by tens of levels on noise."""
    options, fourcc = CONTENT_USERS[user]
    stream = mpeg4_writer.content(small_frames, (7, 3), frames=8, **options)
    for path, mux in ((str(tmp_path / "c.avi"), lambda p: mpeg4_writer.to_avi(stream, p, fourcc)),
                      (str(tmp_path / "c.mp4"), lambda p: mpeg4_writer.to_mp4(stream, p))):
        mux(path)
        stats = assert_cv2s(path)
        assert stats["b_vops"] and stats["inter4v_mbs"] and stats["qpel_vops"]
        _, planes, _ = port_decode(path)
        live = cv2_frames(path, convert_rgb=True)
        gaps = [np.percentile(np.abs(i420_to_bgr(p, 144, 176).astype(int) - ref), 99)
                for p, ref in zip(planes, live)]
        assert max(gaps) <= gaps[0] + 1, (user, path, gaps)


def _carrier_bgr(tmp_path, frames):
    """cv2's BGR of I420 frames carried losslessly as H.264 I_PCM pictures
    (``test_torch_h264.py``'s carrier)."""
    import h264_writer

    path = str(tmp_path / "carrier.h264")
    with open(path, "wb") as f:
        f.write(h264_writer.content(np.stack(frames)))
    return cv2_frames(path, convert_rgb=True)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_chroma_exact_through_pcm_carrier(tmp_path, name):
    """The chroma of every fixture is FFmpeg's to the bit: cv2's BGR of the
    fixture equals cv2's BGR of the port's planes carried as I_PCM."""
    path = os.path.join(ASP_DATA, name)
    _, planes, _ = port_decode(path)
    want = cv2_frames(path, convert_rgb=True)
    got = _carrier_bgr(tmp_path, planes)
    assert len(got) == len(want) == len(planes)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


@pytest.mark.parametrize("name", INTERLACED)
def test_interlaced_fixture_gives_libavcodecs_planes(name):
    """Every plane of every frame is libavcodec's, in cv2's count; cv2's
    own frames are not the decoded pictures (ROADMAP §3)."""
    path = os.path.join(ASP_DATA, name)
    ys, planes, stats = port_decode(path)
    want = DIGESTS[name]
    assert [_sha(p) for p in planes] == want["yuv_sha256"]
    assert stats["interlaced_vops"] == stats["i_vops"] + stats["p_vops"] + stats["b_vops"]
    live = cv2_frames(path)
    assert len(live) == len(ys) == want["frames"]
    assert not any(np.array_equal(a, b) for a, b in zip(ys, live))


def test_interlaced_fixtures_exercise_every_tool():
    totals = {}
    for name in INTERLACED:
        for k, v in port_decode(os.path.join(ASP_DATA, name))[2].items():
            totals[k] = totals.get(k, 0) + v
    for k in ("interlaced_vops", "alt_scan_vops", "field_mbs", "field_dct_mbs",
              "field_direct_mbs", "b_vops", "qpel_vops", "inter4v_mbs", "video_packets"):
        assert totals[k] > 0, (k, totals)


def test_fixtures_exercise_every_tool():
    totals = {}
    per = {}
    for name in FIXTURES:
        stats = port_decode(os.path.join(ASP_DATA, name))[2]
        per[name] = stats
        for k, v in stats.items():
            totals[k] = max(totals.get(k, 0), v) if k.startswith("max_") else \
                totals.get(k, 0) + v
    for k in ("b_vops", "n_vops", "inter4v_mbs", "direct_mbs", "direct_8x8_mbs", "forward_mbs",
              "backward_mbs", "interpolate_mbs", "b_skipped_mbs", "dbquant_mbs", "qpel_vops",
              "mpeg_quant_vops", "custom_matrices", "video_packets", "hec_packets",
              "packed_b_vops", "xvid_idct_vops", "intra_mbs_in_p", "not_coded_mbs",
              "ac_pred_on", "escape_1", "escape_2", "escape_3", "dquant_mbs", "mv_outside"):
        assert totals[k] > 0, (k, totals)
    assert totals["max_fcode"] >= 3 and totals["max_bcode"] >= 3
    idct = per["xvid_idct_64x48.avi"]
    assert idct["xvid_idct_vops"] == idct["i_vops"] + idct["p_vops"] and not idct["b_vops"]
    assert per["xvid_tag_72x40.avi"]["xvid_idct_vops"] > 0  # the tag alone: XviD build 0
    assert not per["lavc_packets_80x48.mp4"]["xvid_idct_vops"]
    for name in ("divx_packed_80x64.avi", "divx_packed_80x64.mp4"):
        assert per[name]["packed_b_vops"] == per[name]["b_vops"] > 0


def test_mutated_fixtures_decode_or_raise_value_error(tmp_path):
    """120 fixture files with random bytes changed, cut, dropped or
    inserted: each reads to its end or raises ValueError."""
    rng = random.Random("mpeg4 asp")
    files = [(n, open(os.path.join(ASP_DATA, n), "rb").read()) for n in FIXTURES + INTERLACED]
    decoded = 0
    for i in range(120):
        name, data = rng.choice(files)
        data = bytearray(data)
        for _ in range(rng.randint(1, 6)):
            pos, r = rng.randrange(len(data)), rng.random()
            if r < 0.7:
                data[pos] = rng.randrange(256)
            elif r < 0.85:
                del data[pos:pos + rng.randint(1, 30)]
            else:
                data[pos:pos] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 12)))
        path = str(tmp_path / f"m{i}{os.path.splitext(name)[1]}")
        with open(path, "wb") as f:
            f.write(data)
        try:
            port_decode(path)
            decoded += 1
        except ValueError:
            continue
    assert 0 < decoded < 120


def test_720p_content_clip_decodes_to_cv2s_digests(tmp_path):
    """The 720p clip (an intra VOP of ``frame_720p.png``, then the pan as
    IBBP with 4MV, quarter-sample vectors and MPEG quantisation, XviD's
    user data), rebuilt by the writer: the port's Y planes hash to the
    digests of cv2's decode in ``mpeg4/sha256.json``."""
    stream = mpeg4_writer.content_720p()
    path = str(tmp_path / "content_720p.avi")
    mpeg4_writer.to_avi(stream, path, b"XVID")
    ys, _, stats = port_decode(path)
    want = DIGESTS["content_720p"]
    assert [_sha(y) for y in ys] == want["y_sha256"]
    assert stats["b_vops"] and stats["inter4v_mbs"] and stats["qpel_vops"] == len(ys)
    assert stats["mpeg_quant_vops"] == stats["xvid_idct_vops"] == len(ys)


def test_decoder_delay_and_flush():
    """``decode`` lets out FFmpeg's frames a sample: a stream with B-VOPs
    holds its first picture back until the next reference and lets the
    last out at ``flush``; the types follow display order."""
    stream = mpeg4_writer.exercise(seed=3, frames=7, bframes=2)
    dec = mpeg4.Decoder(stream.header)
    counts, types = [], []
    for s in stream.samples:
        frames = dec.decode(s)
        counts.append(len(frames))
        types += [dec.last_type] * len(frames)
    tail = dec.flush()
    types += [dec.last_type] * len(tail)
    assert counts[0] == 0 and len(tail) == 1 and sum(counts) + 1 == 7
    assert dec.flush() == []
    display_types = [t for _, t in sorted(zip(stream.display, stream.types))]
    assert "".join(types) == "".join("IPB"[t] for t in display_types)
