"""The port's AVI container (``render/avi.py``) and its readers and writer
(``render/video.AVIReader`` / ``AVIWriter``), and Motion JPEG in MP4/MOV,
against cv2 on the CPU.

* Fixtures (``tests/data/video/avi``, ``make_fixtures.py avi``): cv2's
  ``mp4v``, ``XVID`` and ``MJPG`` AVIs and ``MJPG`` in a ``.mov`` and an
  ``.mp4`` decode to cv2's Y planes (their committed sha256) in cv2's
  count and rate; so does the 720p Motion JPEG clip (``avi_clips.py``),
  whole and as a power cut leaves it.
* H.264 (I/P and B pictures, CAVLC and CABAC) muxed into an AVI by the
  port decodes to cv2's frames, count and order, from the reorder delay
  FFmpeg's probe of an AVI stream finds (0, as for Annex B).
* Damaged and unusual files give cv2's frames: no ``idx1``, a last chunk
  cut by the end of the file, empty chunks, an interleaved PCM audio
  stream before the video one, ``idx1`` offsets from the file's start, a
  non-interleaved file read through its index, and OpenDML files
  (``RIFF AVIX``, ``ix00``, ``indx``) written by the port's muxer with its
  RIFF limit lowered, whole and cut short.
* The writer: cv2 reads the port's ``.avi`` at 30 fps with every frame,
  its Y equal to the writer's reconstruction, in FFmpeg's layout.
* Refusals name the codec or the fault; seeded mutations of a file read
  or raise ``ValueError``.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.ops.preprocess import bgr_to_i420  # noqa: E402
from adas_tpu_torch.render import avi, h264, mp4  # noqa: E402
from adas_tpu_torch.render.video import (AVIReader, AVIWriter, MP4Reader,  # noqa: E402
                                         open_reader, open_writer, output_fps)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
AVI_DATA = os.path.join(DATA, "avi")
sys.path.insert(0, DATA)
import avi_clips  # noqa: E402
import h264_writer  # noqa: E402

with open(os.path.join(AVI_DATA, "sha256.json")) as _f:
    DIGESTS = json.load(_f)
FIXTURES = [n for n in DIGESTS if not n.startswith("clip_")]


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def port_ys(path):
    """The port's Y planes, in order, and what the reader tells: size,
    rate, codec and the decoder's counts."""
    ys = []
    with open_reader(path) as r:
        while (planes := r.read_planes()) is not None:
            ys.append(planes[0] if isinstance(planes, tuple) else planes[:r.height])
        info = {"width": r.width, "height": r.height, "fps": r.fps, "codec": r.codec,
                "stats": r.stats()}
    return ys, info


def cv2_ys(path):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def assert_cv2s(path):
    """The port's frames are cv2's: count, order, Y to the bit."""
    want = cv2_ys(path)
    got, info = port_ys(path)
    assert len(got) == len(want) > 0
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    return info


def _smooth(n, h, w, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 60 * np.sin((x + 4 * t) / 11.0),
                              128 + 50 * np.cos(y / 9.0 + t / 5.0),
                              128 + 70 * np.sin((x + y + 3 * t) / 17.0)], -1)
                    + rng.normal(0, 2, (h, w, 3)), 0, 255).astype(np.uint8) for t in range(n)]


def _jpegs(n=6, h=48, w=64):
    return [cv2.imencode(".jpg", f)[1].tobytes() for f in _smooth(n, h, w)]


def _mux(path, samples, w=64, h=48, fourcc=b"MJPG", keys=None):
    with avi.Muxer(str(path), w, h, fourcc) as m:
        for i, s in enumerate(samples):
            m.add(s, True if keys is None else keys[i])
    return str(path)


# ------------------------------------------------------------------ fixtures

def test_fixtures_are_committed():
    assert len(FIXTURES) == 5
    for name in FIXTURES:
        with open(os.path.join(AVI_DATA, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == DIGESTS[name]["sha256"], name


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_to_cv2s_digests(name):
    want = DIGESTS[name]
    ys, info = port_ys(os.path.join(AVI_DATA, name))
    assert (info["width"], info["height"], info["fps"]) == (want["width"], want["height"],
                                                          want["fps"])
    assert [_sha(y) for y in ys] == want["y_sha256"]
    assert info["codec"] == ("mp4v" if "mp4v" in name or "xvid" in name else "mjpeg")


@pytest.mark.parametrize("damaged", [False, True])
def test_720p_mjpeg_clip_decodes_to_cv2s_digests(tmp_path, damaged):
    """The committed 4:2:0 and 4:2:2 720p JPEGs, alternating, as an MJPG AVI
    by the port's muxer: cv2's digests whole, and with no idx1, its last
    chunk cut in half and its sizes never written (cv2 drops that chunk)."""
    path = str(tmp_path / "clip.avi")
    avi_clips.mjpeg_720p(path, damaged)
    want = DIGESTS["clip_720p_mjpg_damaged.avi" if damaged else "clip_720p_mjpg.avi"]
    ys, info = port_ys(path)
    assert [_sha(y) for y in ys] == want["y_sha256"] and info["fps"] == 30.0
    demux = avi.Demuxer(path)
    assert demux.indexed != damaged and (demux.truncated > 0) == damaged
    demux.close()


def test_mjpeg_in_mp4_and_mov_entries():
    """cv2 writes MJPG into a ``.mov`` as a ``jpeg`` entry and into an
    ``.mp4`` as an ``mp4v`` entry of object type 0x6C; an ``mjpb`` entry
    (MJPEG-B) is refused by name."""
    for name, entry in (("cv2_mjpg_96x64.mov", b"jpeg"), ("cv2_mjpg_96x64.mp4", b"mp4v")):
        with open(os.path.join(AVI_DATA, name), "rb") as f:
            data = f.read()
        assert entry in data
        demux = mp4.Demuxer(os.path.join(AVI_DATA, name))
        assert demux.track.codec == "mjpeg"
        demux.close()


def test_mjpb_entry_raises(tmp_path):
    with open(os.path.join(AVI_DATA, "cv2_mjpg_96x64.mov"), "rb") as f:
        data = f.read()
    path = tmp_path / "v.mov"
    path.write_bytes(data.replace(b"jpeg", b"mjpb", 1))
    with pytest.raises(ValueError, match="MJPEG-B"):
        MP4Reader(str(path))


# ------------------------------------------------------------------ H.264

def _h264_avi(stream, path, w, h, fourcc=b"H264"):
    with avi.Muxer(str(path), w, h, fourcc) as m:
        for au in h264.access_units(h264.nal_units(stream)):
            m.add(h264.annexb(au), any(n[0] & 0x1F == 5 for n in au))
    return str(path)


@pytest.mark.parametrize("case", ["content_ip", "content_b2", "cavlc_b", "cabac_b"])
def test_h264_in_avi_equals_cv2(tmp_path, case):
    """I/P and B pictures (a B pyramid, spatial and temporal direct) in an
    AVI: cv2's count, order and Y, from FFmpeg's probed reorder delay."""
    from make_fixtures import H264_FIXTURES

    if case.startswith("content"):
        first = bgr_to_i420(_smooth(1, 64, 96)[0])
        stream = h264_writer.content(first, n_p=7, pan=(6, -3),
                                     bframes=2 if case == "content_b2" else 0)
        w, h, tag = 96, 64, b"H264"
    else:
        options = H264_FIXTURES["cavlc_b_96x64.h264" if case == "cavlc_b"
                                else "cabac_b_112x64.mp4"][0]
        stream = h264_writer.exercise(**options)
        w, h, tag = options["width"], options["height"], b"avc1"
    stats = assert_cv2s(_h264_avi(stream, tmp_path / "v.avi", w, h, tag))["stats"]
    assert stats["dropped_pictures"] == 0
    assert (stats["b_slices"] > 0) == (case != "content_ip")


# ------------------------------------------------------------------ damaged files

def test_without_idx1_and_with_file_offsets(tmp_path):
    """Without ``idx1`` the file is scanned; an ``idx1`` whose offsets count
    from the file's start is aligned to the first chunk as FFmpeg aligns it."""
    path = _mux(tmp_path / "v.avi", _jpegs())
    data = open(path, "rb").read()
    i = data.rindex(b"idx1")
    bare = tmp_path / "bare.avi"
    bare.write_bytes(data[:i])
    assert_cv2s(str(bare))
    assert not avi.Demuxer(str(bare)).indexed
    movi = data.index(b"movi")
    absolute = bytearray(data)
    for k in range((len(data) - i - 8) // 16):
        o = i + 8 + 16 * k + 8
        struct.pack_into("<I", absolute, o, struct.unpack_from("<I", absolute, o)[0] + movi)
    path2 = tmp_path / "abs.avi"
    path2.write_bytes(bytes(absolute))
    demux = avi.Demuxer(str(path2))
    relative = avi.Demuxer(path)
    assert demux._idx1()[0] == relative._idx1()[0] and demux.indexed
    demux.close()
    relative.close()
    assert_cv2s(str(path2))


@pytest.mark.parametrize("cut", ["mid_chunk_sizes_zero", "in_chunk_header", "mid_chunk"])
def test_truncated_last_chunk(tmp_path, cut):
    """A file cut by the end of the disk or a power loss.  With its sizes
    unwritten (0), or cut inside a chunk header, cv2 drops the last chunk
    as the port does.  With the sizes of the finished file, FFmpeg hands
    the decoder the partial chunk (``Demuxer.partial``), its scan stops at
    the overread and the frame comes out ("EOI missing"); the port does
    the same, and the macroblocks past the data show the frame before, as
    cv2's do (FFmpeg's frame pool hands the decoder that frame's buffer):
    all 7 frames are cv2's to the bit."""
    path = _mux(tmp_path / "v.avi", _jpegs(8))
    demux = avi.Demuxer(path)
    off, size = demux.offsets[6], demux.sizes[6]
    demux.close()
    data = bytearray(open(path, "rb").read())
    data = data[:off - 4] if cut == "in_chunk_header" else data[:off + size // 2]
    if cut == "mid_chunk_sizes_zero":
        data[4:8] = bytes(4)
        movi = data.index(b"movi")
        data[movi - 4:movi] = bytes(4)
    bad = tmp_path / "cut.avi"
    bad.write_bytes(bytes(data))
    want = cv2_ys(str(bad))
    got, info = port_ys(str(bad))
    assert len(got) == len(want) == (7 if cut == "mid_chunk" else 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert info["stats"]["overread_scans"] == (cut == "mid_chunk")


@pytest.mark.parametrize("codec", ["mp4v", "h264"])
def test_cut_mp4v_and_h264_chunks_give_one_frame_fewer(tmp_path, codec):
    """The same cut (the sizes written) of an ``mp4v`` or H.264 AVI: FFmpeg
    hands the decoder the partial chunk and conceals what it lacks
    (error_resilience.c), and so does the port: cv2's 7 frames, not one
    fewer as before concealment (ROADMAP §3, repaired).  Every plane of
    every frame is libavcodec's one-thread decode, and the Y planes are
    cv2's, but for the concealed H.264 picture, whose frame-threaded decode
    in cv2 reads FFmpeg's pooled motion tables in another order
    (``test_torch_conceal.py``)."""
    from make_fixtures import libavcodec_planes

    src = str(tmp_path / "v.avi")
    if codec == "mp4v":
        with AVIWriter(src, 96, 64) as w:
            for f in _smooth(8, 64, 96):
                w.write(f)
    else:
        stream = h264_writer.exercise(frames=8, width=64, height=48, seed=3)
        _mux(src, [h264.annexb(au) for au in h264.access_units(h264.nal_units(stream))], 64, 48,
             b"H264")
    demux = avi.Demuxer(src)
    off, size = demux.offsets[6], demux.sizes[6]
    demux.close()
    bad = tmp_path / "cut.avi"
    bad.write_bytes(open(src, "rb").read()[:off + size // 2])
    demux = avi.Demuxer(str(bad))
    assert demux.partial and len(demux) == 7
    samples = [demux.read(i) for i in range(len(demux))]
    demux.close()
    want = cv2_ys(str(bad))
    lav = libavcodec_planes(samples, b"FMP4" if codec == "mp4v" else b"", 12 if codec == "mp4v" else 27)
    got, info = port_ys(str(bad))
    assert len(got) == len(want) == len(lav) == 7
    for k, (a, b, c) in enumerate(zip(got, want, lav)):
        np.testing.assert_array_equal(a, c[0], err_msg=f"frame {k}")
        if codec == "mp4v" or k < 6:
            np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert info["stats"]["concealed_mbs"] > 0


def test_720p_mjpeg_clip_cut_mid_chunk_gives_cv2s_digests(tmp_path):
    """The 720p clip cut in its last chunk after its sizes were written: 24
    frames, the last decoded as far as its data goes (its 4:2:2 format is
    not the frame before's, so the rest comes from a new buffer: zeros),
    all to cv2's digests."""
    path = str(tmp_path / "clip.avi")
    avi_clips.mjpeg_720p(path, cut=True)
    ys, info = port_ys(path)
    with open(os.path.join(AVI_DATA, "cut_sha256.json")) as f:
        want = json.load(f)["clip_720p_mjpg_cut.avi"]
    assert len(ys) == want["frames"] == avi_clips.FRAMES
    assert [_sha(y) for y in ys] == want["y_sha256"]
    assert info["stats"]["overread_scans"] == 1


def test_empty_chunks_are_skipped(tmp_path):
    jp = _jpegs(5)
    samples = [s for j in jp for s in (j, b"")]
    path = _mux(tmp_path / "v.avi", samples)
    assert_cv2s(path)
    assert len(avi.Demuxer(path)) == 5


def _two_stream_avi(path, video, audio_first_all=False):
    """An AVI of a PCM audio stream (00wb, 8 kHz mono 16-bit) and the
    ``MJPG`` video stream (01dc), interleaved or all audio first, with an
    idx1; the layout built chunk by chunk."""
    w, h = 64, 48
    ck = avi.chunk
    avih = struct.pack("<10I16x", 33333, 0, 0, 0x910, len(video), 0, 2, 1 << 20, w, h)
    a_strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"auds", bytes(4), 0, 0, 0, 0, 1, 8000, 0,
                         8000 * len(video) // 30, 4096, 0xFFFFFFFF, 2, 0, 0, 0, 0)
    a_strf = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
    v_strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, 1, 30, 0,
                         len(video), 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    v_strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = (b"hdrl" + ck(b"avih", avih) + ck(b"LIST", b"strl" + ck(b"strh", a_strh)
                                               + ck(b"strf", a_strf))
            + ck(b"LIST", b"strl" + ck(b"strh", v_strh) + ck(b"strf", v_strf)))
    audio = [bytes(1066 + 2 * (i % 2)) for i in range(len(video))]
    order = ([(b"00wb", a) for a in audio] + [(b"01dc", v) for v in video] if audio_first_all
             else [c for a, v in zip(audio, video) for c in ((b"00wb", a), (b"01dc", v))])
    movi, idx, pos = b"movi", b"", 4
    for tag, body in order:
        idx += struct.pack("<4sIII", tag, 0x10, pos, len(body))
        movi += ck(tag, body)
        pos += 8 + len(body) + (len(body) & 1)
    body = b"AVI " + ck(b"LIST", hdrl) + ck(b"LIST", movi) + ck(b"idx1", idx)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


@pytest.mark.parametrize("layout", ["interleaved", "audio_first"])
def test_pcm_audio_stream_is_skipped(tmp_path, layout):
    """The video is stream 01 behind a PCM audio stream 00: interleaved, it
    is read in file order; with all audio first, FFmpeg reads the file as
    non-interleaved, through its index, and so does the port."""
    path = _two_stream_avi(tmp_path / "v.avi", _jpegs(6), layout == "audio_first")
    assert_cv2s(path)
    demux = avi.Demuxer(path)
    assert demux.stream.number == 1 and demux.n_streams == 2
    assert demux.non_interleaved == (layout == "audio_first")
    demux.close()


def test_opendml_file_reads_back_whole(tmp_path, monkeypatch):
    """With the RIFF limit lowered, the muxer writes ``RIFF AVIX``
    extensions, an ``ix00`` per RIFF, ``idx1`` in the first, the ``indx``
    super index and the ``odml`` list, as FFmpeg past 1 GiB; cv2 and the
    port read every frame, the port through the OpenDML index.  Cut short
    in its last RIFF, both read the frames before the cut."""
    monkeypatch.setattr(avi, "RIFF_LIMIT", 20000)
    jp = _jpegs(6)
    path = _mux(tmp_path / "v.avi", jp * 5)
    data = open(path, "rb").read()
    assert data.count(b"AVIX") >= 2 and data.count(b"ix00") == data.count(b"AVIX") + 1
    assert data.count(b"idx1") == 1 and b"indx" in data and b"LISTT" not in data
    odml = data.index(b"odml")
    assert data[odml - 8:odml - 4] == b"LIST" and data[odml + 12:odml + 16] == struct.pack("<I", 30)
    demux = avi.Demuxer(path)
    assert demux.indexed and len(demux) == 30 and all(demux.keys)
    demux.close()
    assert_cv2s(path)
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:len(data) - 3000])
    assert_cv2s(str(cut))


# ------------------------------------------------------------------ the writer

def test_writer_is_read_by_cv2_at_30_fps(tmp_path):
    """``open_writer('x.avi')`` writes mp4v at 30 fps in FFmpeg's layout:
    cv2 reads every frame, its Y the writer's reconstruction, within the
    MP4 writer's PSNR bound of the source; ``idx1`` flags the I-VOPs, each
    of which carries the VOS/VOL headers in band."""
    from test_torch_video import SMOOTH_PSNR_DB, _psnr

    frames = _smooth(26, 64, 96)
    path = str(tmp_path / "out.avi")
    assert output_fps(path, 12.0) == 30.0
    with open_writer(path, 96, 64, output_fps(path, 12.0)) as w:
        assert isinstance(w, AVIWriter)
        recon = [w.write(f) for f in frames]
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FPS) == 30.0 and cap.get(cv2.CAP_PROP_FRAME_COUNT) == 26
    cap.release()
    want = cv2_ys(path)
    assert len(want) == 26
    for r, y, f in zip(recon, want, frames):
        np.testing.assert_array_equal(r[:64], y)
        assert _psnr(y, bgr_to_i420(f)[:64]) >= SMOOTH_PSNR_DB
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:16] == b"AVI LIST"
    assert data.index(b"strh") < data.index(b"vidsmp4v") < data.index(b"strf")
    assert struct.unpack_from("<I", data, data.index(b"JUNK") + 4)[0] == 4120
    assert data.index(b"odmldmlh") < data.index(b"INFO") < data.index(b"movi")
    demux = avi.Demuxer(path)
    assert demux.keys == [i % 12 == 0 for i in range(26)]
    chunks = [demux.read(i) for i in range(26)]
    assert all(c.startswith(b"\x00\x00\x01\xb0") == (i % 12 == 0) for i, c in enumerate(chunks))
    demux.close()
    with AVIReader(path) as r:
        assert r.fps == 30.0 and len(r) == 26
        for got, rec in zip(r.i420_frames(), recon):
            np.testing.assert_array_equal(got, rec)


def test_muxer_takes_any_fourcc_and_rate(tmp_path):
    path = _mux(tmp_path / "v.avi", _jpegs(3))
    with AVIReader(path) as r:
        assert r.codec == "mjpeg" and r.fps == 30.0 and len(list(r)) == 3
    with avi.Muxer(str(tmp_path / "n.avi"), 64, 48, b"MJPG", 30000 / 1001) as m:
        for j in _jpegs(2):
            m.add(j, True)
    with AVIReader(str(tmp_path / "n.avi")) as r:
        assert abs(r.fps - 29.97) < 1e-3
    assert abs(cv2.VideoCapture(str(tmp_path / "n.avi")).get(cv2.CAP_PROP_FPS) - 29.97) < 1e-2


# ------------------------------------------------------------------ refusals

def _with_tag(data, tag):
    """The file with its video stream's strh handler and strf compression
    set to ``tag``."""
    b = bytearray(data)
    strf = data.index(b"strf") + 8
    b[strf + 16:strf + 20] = tag
    return bytes(b)


@pytest.mark.parametrize("tag,name", [(b"HEVC", "H.265"), (b"hvc1", "H.265"),
                                      (b"mjpb", "MJPEG-B"), (b"\0\0\0\0", "raw DIB"),
                                      (b"DIB ", "raw DIB"), (b"WMV3", "WMV9"),
                                      (b"zzzz", "'zzzz'")])
def test_other_codecs_raise_by_name(tmp_path, tag, name):
    data = open(_mux(tmp_path / "v.avi", _jpegs(2)), "rb").read()
    path = tmp_path / "bad.avi"
    path.write_bytes(_with_tag(data, tag))
    with pytest.raises(ValueError, match=name):
        AVIReader(str(path))


def _shrink_strh(data):
    """The file with its strh cut to 48 bytes, the lists around it resized."""
    b = bytearray(data)
    strh = data.index(b"strh")
    del b[strh + 8 + 48:strh + 8 + 56]
    struct.pack_into("<I", b, strh + 4, 48)
    for at in (data.index(b"strl") - 4, data.index(b"hdrl") - 4, 4):
        struct.pack_into("<I", b, at, struct.unpack_from("<I", b, at)[0] - 8)
    return bytes(b)


def test_corrupt_structure_raises(tmp_path):
    data = open(_mux(tmp_path / "v.avi", _jpegs(2)), "rb").read()
    path = tmp_path / "bad.avi"
    cases = {
        "not an AVI": b"RIFX" + data[4:],
        "no hdrl": data[:12] + b"JUNK" + data[16:],
        "under 56": _shrink_strh(data),
        "runs past": data[:data.index(b"hdrl")] + bytes(4),
        "no movi": data[:data.index(b"LIST", data.index(b"INFO") + 8)],
        "without a video stream": data.replace(b"vidsMJPG", b"audsMJPG", 1),
    }
    for name, bad in cases.items():
        path.write_bytes(bad)
        with pytest.raises(ValueError, match=name):
            AVIReader(str(path))
    path.write_bytes(data)
    with AVIReader(str(path)) as r:
        assert len(list(r)) == 2


def test_divx_packed_bvops_raise(tmp_path):
    """DivX's packed B-VOPs are decoded now (``test_torch_mpeg4_asp.py``):
    a stream whose user data says so reads as cv2 reads it."""
    frames = _smooth(2, 64, 96)
    src = str(tmp_path / "v.avi")
    with AVIWriter(src, 96, 64) as w:
        for f in frames:
            w.write(f)
    demux = avi.Demuxer(src)
    chunks = [demux.read(i) for i in range(len(demux))]
    demux.close()
    vop = chunks[0].index(b"\x00\x00\x01\xb6")
    chunks[0] = chunks[0][:vop] + b"\x00\x00\x01\xb2DivX503b1393p" + chunks[0][vop:]
    path = tmp_path / "packed.avi"
    _mux(path, chunks, 96, 64, b"DX50", keys=[True, False])
    demux = avi.Demuxer(str(path))
    first = demux.read(0)
    demux.close()
    assert b"DivX503b1393p" in first
    assert_cv2s(str(path))


@pytest.mark.parametrize("name", ["cv2_mjpg_96x64.avi", "cv2_mp4v_96x64.avi"])
def test_mutated_files_read_or_raise_value_error(name):
    """Seeded mutations of a fixture (byte flips, cuts, a chunk size
    rewritten) read to their end or raise ``ValueError``."""
    import tempfile

    data = open(os.path.join(AVI_DATA, name), "rb").read()
    rng = np.random.default_rng(11)
    outcomes = {"ok": 0, "error": 0}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.avi")
        for _ in range(60):
            b = bytearray(data)
            kind = rng.integers(3)
            if kind == 0:
                for _ in range(int(rng.integers(1, 8))):
                    b[int(rng.integers(len(b)))] = int(rng.integers(256))
            elif kind == 1:
                b = b[:int(rng.integers(12, len(b)))]
            else:
                sizes = [i + 4 for i in range(len(b) - 8) if b[i:i + 4] in (b"00dc", b"LIST")]
                o = sizes[int(rng.integers(len(sizes)))]
                struct.pack_into("<I", b, o, int(rng.integers(1 << 32)))
            with open(path, "wb") as f:
                f.write(bytes(b))
            try:
                with AVIReader(path) as r:
                    for _ in r:
                        pass
                outcomes["ok"] += 1
            except ValueError:
                outcomes["error"] += 1
    assert outcomes["ok"] > 0 and outcomes["error"] > 0


def test_unpadded_odd_chunks_read_as_cv2_reads_them(tmp_path):
    """A writer that does not pad odd-sized chunks to even sizes: the next
    header sits at the odd position, where FFmpeg's byte scan finds it,
    and so does the port's."""
    jp = _jpegs(6)
    jp = [j if len(j) % 2 else j + b"\x00" for j in jp]  # every chunk odd-sized
    data = bytearray(open(_mux(tmp_path / "v.avi", jp), "rb").read())
    data = data[:data.rindex(b"idx1")]
    movi = data.index(b"movi")
    body = data[movi + 4:]
    out, pos = b"", 0
    while pos + 8 <= len(body):
        n = struct.unpack_from("<I", body, pos + 4)[0]
        out += body[pos:pos + 8 + n]
        pos += 8 + n + (n & 1)
    data = data[:movi + 4] + out
    struct.pack_into("<I", data, movi - 4, len(out) + 4)
    struct.pack_into("<I", data, 4, len(data) - 8)
    path = tmp_path / "unpadded.avi"
    path.write_bytes(bytes(data))
    assert assert_cv2s(str(path))["codec"] == "mjpeg"
    assert len(avi.Demuxer(str(path))) == 6
