"""The port's MP4 container (``adas_tpu_torch/render/mp4.py``) on the CPU.

The writer's layout (``moov`` after ``mdat``, as cv2's writer puts it)
and rebuilt variants of the same samples: ``moov`` first, ``co64`` chunk
offsets, several chunks per ``stsc`` run, one chunk for every sample, and
an audio track before the video's.  The demuxer gives the same samples
from each, and cv2 reads each file's frames as the port does.  H.264
tracks (``avc1``, ``avc3``) demux with their ``avcC`` record; with B
pictures, with ``ctts`` (versions 0 and 1) and ``edts``/``elst`` as
FFmpeg's muxer writes them, and the reorder depth FFmpeg's mov demuxer
reads from them.  An ``avc1`` entry without ``avcC``, an ``hvc1`` sample
entry, an esds of another object type, fragmented MP4, edit lists that
cut frames and truncated files raise ``ValueError`` by name.
"""
from __future__ import annotations

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.render import mp4  # noqa: E402
from adas_tpu_torch.render.video import (MP4Reader, MP4Writer, open_reader,  # noqa: E402
                                         open_writer)
from test_torch_mpeg4 import _cv2_frames, smooth  # noqa: E402

H, W, N = 48, 64, 30


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """An MP4 of 30 frames by the writer: its path, samples, DecoderSpecificInfo
    and the writer's reconstructions."""
    path = str(tmp_path_factory.mktemp("mp4") / "w.mp4")
    with MP4Writer(path, W, H, 30.0) as vw:
        recon = [vw.write(f) for f in smooth(N, H, W, 4, seed=9)]
    d = mp4.Demuxer(path)
    samples = [d.read(i) for i in range(len(d))]
    dsi = d.track.dsi
    d.close()
    return path, samples, dsi, recon


def _rebuild(path, samples, dsi, moov_first=False, co64=False, per_chunk=12, audio=False):
    """The samples in one mdat, laid out in chunks of ``per_chunk``."""
    keys = [i + 1 for i in range(len(samples)) if i % 12 == 0]

    def moov(base):
        offsets, pos = [], base
        for i, s in enumerate(samples):
            if i % per_chunk == 0:
                offsets.append(pos)
            pos += len(s)
        m = mp4.build_moov(W, H, dsi, 30, 1, [len(s) for s in samples], keys, offsets,
                           per_chunk)
        if co64:  # the same offsets in 64 bits
            m = _rewrite(m, b"stco", _co64)
        if audio:  # the audio trak goes before the video's
            m = _audio_first(m, _audio_trak())
        return m

    mdat_body = b"".join(samples)
    if moov_first:
        size = len(moov(0))
        data = mp4.FTYP + moov(len(mp4.FTYP) + size + 8) + mp4.box(b"mdat", mdat_body)
    else:
        data = mp4.FTYP + mp4.box(b"mdat", mdat_body)
        data += moov(len(mp4.FTYP) + 8)
    with open(path, "wb") as f:
        f.write(data)


_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


def _rewrite(data: bytes, kind: bytes, new) -> bytes:
    """``data`` with every ``kind`` box in the sample table's containers
    replaced by ``new(payload)``; other boxes kept byte for byte."""
    out, pos = b"", 0
    for k, s, e in mp4.iter_boxes(data):
        if k == kind:
            out += new(data[s:e])
        elif k in _CONTAINERS:
            out += mp4.box(k, _rewrite(data[s:e], kind, new))
        else:
            out += data[pos:e]
        pos = e
    return out


def _co64(stco: bytes) -> bytes:
    n = struct.unpack_from(">I", stco, 4)[0]
    offsets = struct.unpack_from(f">{n}I", stco, 8)
    return mp4.full_box(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *offsets))


def _audio_trak():
    mdhd = mp4.full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, 44100, 0), bytes(4))
    hdlr = mp4.full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"soun"), bytes(12), b"Sound\0")
    return mp4.box(b"trak", mp4.full_box(b"tkhd", 0, 3, bytes(80)),
                   mp4.box(b"mdia", mdhd, hdlr, mp4.box(b"minf")))


def _audio_first(moov, trak):
    kids = [moov[s - 8:e] for _, s, e in mp4.iter_boxes(moov, 8)]
    mvhd, video = kids[0], kids[1]
    return mp4.box(b"moov", mvhd, trak, video)


def _frames(path):
    with MP4Reader(path) as r:
        return list(r.i420_frames()), r.fps


@pytest.mark.parametrize("layout", [
    {}, {"moov_first": True}, {"co64": True}, {"moov_first": True, "co64": True},
    {"per_chunk": 5}, {"per_chunk": 1}, {"per_chunk": 30}, {"audio": True},
], ids=["moov-last", "moov-first", "co64", "moov-first-co64", "chunks-of-5", "chunk-per-sample",
        "one-chunk", "audio-track-first"])
def test_layouts_give_the_same_frames(written, tmp_path, layout):
    path, samples, dsi, recon = written
    out = str(tmp_path / "v.mp4")
    _rebuild(out, samples, dsi, **layout)
    data = open(out, "rb").read()
    moov = next(data[s:e] for k, s, e in mp4.iter_boxes(data) if k == b"moov")
    assert (b"co64" in moov, b"stco" in moov) == ((True, False) if layout.get("co64")
                                                  else (False, True))
    d = mp4.Demuxer(out)
    assert [d.read(i) for i in range(len(d))] == samples
    d.close()
    got, fps = _frames(out)
    assert fps == 30.0 and len(got) == N
    for g, r in zip(got, recon):
        np.testing.assert_array_equal(g, r)
    live, cv2_fps = _cv2_frames(out, convert_rgb=False)
    assert cv2_fps == 30.0 and len(live) == N
    for g, y in zip(got, live):
        np.testing.assert_array_equal(g[:H], y)


def test_writer_layout(written):
    """ftyp, mdat (64-bit size), moov; the sample table as written."""
    path, samples, _, _ = written
    data = open(path, "rb").read()
    kinds = [k for k, _, _ in mp4.iter_boxes(data)]
    assert kinds == [b"ftyp", b"mdat", b"moov"]
    d = mp4.Demuxer(path)
    assert (d.track.width, d.track.height, d.track.timescale, d.track.duration) == (W, H, 30, N)
    d.close()
    moov = next(data[s:e] for k, s, e in mp4.iter_boxes(data) if k == b"moov")
    for box in (b"mvhd", b"tkhd", b"mdhd", b"hdlr", b"vmhd", b"dref", b"stsd", b"esds", b"stts",
                b"stss", b"stsc", b"stsz", b"stco"):
        assert box in moov, box
    assert b"co64" not in moov


def test_rate():
    assert mp4.rate(30.0) == (30, 1)
    assert mp4.rate(30000 / 1001) == (30000, 1001)
    assert mp4.rate(12.5) == (25, 2)
    with pytest.raises(ValueError):
        mp4.rate(0)


def _with_entry(data: bytes, fourcc: bytes) -> bytes:
    i = data.index(b"mp4v")
    return data[:i] + fourcc + data[i + 4:]


@pytest.mark.parametrize("fourcc,name", [(b"avc1", "H.264"), (b"hvc1", "H.265"),
                                         (b"av01", "AV1"), (b"xyz1", "'xyz1'")])
def test_other_codecs_raise_by_name(written, tmp_path, fourcc, name):
    data = _with_entry(open(written[0], "rb").read(), fourcc)
    path = tmp_path / "v.mp4"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=name):
        MP4Reader(str(path))


def test_other_object_types_and_fragments_raise(written, tmp_path):
    data = open(written[0], "rb").read()
    esds = data.index(b"esds")
    config = data.index(b"\x04", esds + 8)  # the DecoderConfigDescriptor's tag
    bad = bytearray(data)
    bad[config + 2] = 0x6A  # its objectTypeIndication, after a 1-byte size
    path = tmp_path / "v.mp4"
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="MPEG-1"):
        MP4Reader(str(path))
    path.write_bytes(mp4.FTYP + mp4.box(b"moof", bytes(8)) + data[len(mp4.FTYP):])
    with pytest.raises(ValueError, match="fragmented"):
        MP4Reader(str(path))
    path.write_bytes(data[:len(data) - 40])  # the moov cut short
    with pytest.raises(ValueError, match="MP4"):
        MP4Reader(str(path))
    path.write_bytes(mp4.FTYP + mp4.box(b"mdat", bytes(16)))
    with pytest.raises(ValueError, match="moov"):
        MP4Reader(str(path))


def test_fixed_sample_size_past_the_file_raises(written, tmp_path):
    """A fixed-size ``stsz`` whose count runs the samples past the file
    raises before any table of that count is built."""
    data = open(written[0], "rb").read()
    path = tmp_path / "v.mp4"
    for fixed, count in ((1, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (len(data), 2)):
        path.write_bytes(_rewrite(data, b"stsz", lambda _: mp4.full_box(
            b"stsz", 0, 0, struct.pack(">II", fixed, count))))
        with pytest.raises(ValueError, match="stsz"):
            MP4Reader(str(path))


def test_suffixes_pick_the_format(written, tmp_path):
    with open_reader(written[0]) as r:
        assert isinstance(r, MP4Reader)
    for suffix in (".m4v", ".mov", ".MP4"):
        out = str(tmp_path / f"v{suffix}")
        with open_writer(out, W, H, 30.0) as vw:
            vw.write(np.zeros((H, W, 3), np.uint8))
        with open_reader(out) as r:
            assert len(list(r)) == 1
    for bad in ("v.webm", "v.mkv", "v"):
        with pytest.raises(ValueError, match=r"\.mp4.*\.y4m"):
            open_reader(str(tmp_path / bad))
        with pytest.raises(ValueError, match=r"\.mp4.*\.y4m"):
            open_writer(str(tmp_path / bad), W, H)


@pytest.mark.parametrize("fourcc", [b"avc1", b"avc3"])
def test_h264_tracks_demux_with_their_avcc(tmp_path, fourcc):
    """An H.264 track: ``Track.codec`` names it, ``dsi`` is its ``avcC``
    record (``avc3``: no parameter sets there, they come in band), the
    samples are the length-prefixed access units, and cv2 reads as many
    frames as the port."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video"))
    import h264_writer as hw

    from adas_tpu_torch.render import h264

    stream = hw.exercise(seed=3, frames=4, width=W, height=H)
    path = str(tmp_path / "h.mp4")
    assert hw.to_mp4(stream, path, fourcc) == 4
    d = mp4.Demuxer(path)
    track, samples = d.track, [d.read(i) for i in range(len(d))]
    d.close()
    assert track.codec == fourcc.decode() and track.fps == 30.0
    length_size, nals = h264.parse_avcc(track.dsi)
    assert length_size == 4 and [n[0] & 0x1F for n in nals] == ([] if fourcc == b"avc3" else [7, 8])
    kinds = [samples[0][4] & 0x1F]
    assert kinds == ([7] if fourcc == b"avc3" else [5])
    with MP4Reader(path) as r:
        assert (r.width, r.height) == (W, H) and len(list(r)) == 4
    assert len(_cv2_frames(path, False)[0]) == 4


def test_h264_entry_without_avcc_raises(written, tmp_path):
    path = tmp_path / "v.mp4"
    path.write_bytes(_with_entry(open(written[0], "rb").read(), b"avc1"))
    with pytest.raises(ValueError, match=r"H\.264 \(avc1\) sample entry without an avcC"):
        MP4Reader(str(path))


def _b_mp4(tmp_path, **options):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video"))
    import h264_writer as hw

    stream = hw.exercise(width=W, height=H, **options)
    path = str(tmp_path / "b.mp4")
    hw.to_mp4(stream, path, b"avc1", fps=25.0)
    return stream, path, hw


@pytest.mark.parametrize("pyramid,depth", [(0, 1), (1, 2)])
def test_b_tracks_carry_ctts_and_elst(tmp_path, pyramid, depth):
    """A B stream's MP4: ``ctts`` gives each sample's display position less
    its decoding position (plus the depth), the ``elst`` starts at the
    first frame's composition time, ``video_delay`` is the reorder depth;
    the reader gives cv2's frames, all of them."""
    from adas_tpu_torch.render import h264

    stream, path, hw = _b_mp4(tmp_path, seed=4, frames=11, bframes=3, pyramid=pyramid, cabac=1)
    d = mp4.Demuxer(path)
    track = d.track
    d.close()
    want = hw.composition_offsets(list(h264.access_units(h264.nal_units(stream))))
    assert track.cts == want and min(want) == 0 and want[0] == depth
    assert track.video_delay == depth and track.fps == 25.0
    data = open(path, "rb").read()
    elst = data.index(b"elst")
    assert struct.unpack_from(">IIi", data, elst + 8)[0::2] == (1, depth)
    with MP4Reader(path) as r:
        got = [p[:H] for p in r.i420_frames()]
        assert len(r) == 11 and r.stats()["dropped_pictures"] == 0
    ys, _ = _cv2_frames(path, False)
    assert len(got) == len(ys) == 11
    for g, y in zip(got, ys):
        np.testing.assert_array_equal(g, y.reshape(H, W))


def test_guess_video_delay_is_the_reorder_depth():
    """The mov demuxer's guess: the most earlier presentation times above a
    sample's, among the 16 largest."""
    assert mp4.guess_video_delay([0, 1, 2, 3]) == 0
    assert mp4.guess_video_delay([0, 3, 1, 2, 6, 4, 5]) == 1
    assert mp4.guess_video_delay([0, 4, 2, 1, 3, 8, 6, 5, 7]) == 2
    assert mp4.guess_video_delay(list(range(40, 20, -1))) == 16


def test_ctts_version_1_takes_negative_offsets():
    box = mp4.full_box(b"ctts", 1, 0, struct.pack(">I", 2), struct.pack(">Ii", 1, -2),
                       struct.pack(">Ii", 2, 5))
    assert mp4._ctts(box, 0, len(box), 3) == [-2, 5, 5]
    with pytest.raises(ValueError, match="ctts gives 3 samples, stsz 4"):
        mp4._ctts(box, 0, len(box), 4)


def test_edit_lists_that_cut_frames_raise(tmp_path):
    """An ``elst`` that starts after the first frame, or holds two edits,
    would have FFmpeg drop or repeat frames: it raises by name."""
    _, path, _ = _b_mp4(tmp_path, seed=5, frames=6, bframes=1)
    data = bytearray(open(path, "rb").read())
    at = data.index(b"elst") + 16  # the first edit's media_time
    start = struct.unpack_from(">i", data, at)[0]
    struct.pack_into(">i", data, at, start + 2)
    bad = tmp_path / "late.mp4"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="edit lists that cut or repeat frames"):
        MP4Reader(str(bad))
    struct.pack_into(">i", data, at, start - 1)  # earlier than the first frame: nothing cut
    ok = tmp_path / "early.mp4"
    ok.write_bytes(bytes(data))
    with MP4Reader(str(ok)) as r:
        assert len(list(r.i420_frames())) == 6
