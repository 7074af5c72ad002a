"""Damaged and cut video as cv2's decoder gives it: FFmpeg's error
concealment (``adas_tpu_torch/native/error_resilience.h``) in the port's
``mp4v`` and H.264 decoders, on the CPU.

Each case damages a seeded stream in one picture -- the file cut in the
middle of a chunk, 3-40 bytes of a slice's or video packet's macroblock
data replaced, a slice or packet dropped, a reference picture dropped (a
gap in H.264's frame_num), an Annex B stream cut in the middle of a NAL
unit -- and holds the port to cv2's bundled FFmpeg reading the file as cv2
reads it (libavformat's demuxer and stream probe) and decoding it on one
thread: the frame count, and every plane of every frame to the bit.  cv2
itself gives the same count, and the frames the damage does not reach
equal cv2's Y to the bit.

Why one thread past the damage: cv2 decodes with frame threads, and where
FFmpeg conceals, a threaded decode is not a function of the stream alone.
cv2's own ``mp4v`` decode of one damaged file differs from run to run (the
padding-bug score FFmpeg logs for the damaged picture differed between
runs), and its H.264 decode of a concealed picture differs from the
one-thread decode, even with concealment off, as the threads reuse
FFmpeg's pooled picture tables in another order.  The one-thread decode is
the decoder's result without those artefacts.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.render import avi, h264  # noqa: E402
from adas_tpu_torch.render.video import AVIWriter, open_reader  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
sys.path.insert(0, DATA)
import h264_writer  # noqa: E402
import mpeg4_writer  # noqa: E402
from make_fixtures import libavformat_planes  # noqa: E402
from test_torch_avi import _smooth, cv2_ys as _cv2_ys  # noqa: E402

MPEG4, H264 = 12, 27  # libavcodec's codec ids
SEEDS = (0, 1, 2)


def _planes(frame, w, h):
    f = np.asarray(frame).ravel()
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return (f[:w * h].reshape(h, w), f[w * h:w * h + cw * ch].reshape(ch, cw),
            f[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw))


def _port(path):
    out = []
    with open_reader(path) as r:
        while (planes := r.read_planes()) is not None:
            out.append(_planes(planes, r.width, r.height))
        stats = r.stats()
    return out, stats


def _samples(path):
    d = avi.Demuxer(path)
    try:
        return [d.read(i) for i in range(len(d))]
    finally:
        d.close()


#: cases where the port departs from libavcodec (ROADMAP §3), each pinned
#: here: cv2's count and the frames the damage does not reach are held as
#: in every case, the rest must still differ.  In each a macroblock failed
#: in its residual: FFmpeg leaves the coefficients it had read in its
#: block buffer, and the next transform that finds them there (a later
#: macroblock's, or concealment's chroma DC add) takes them in; the port
#: keeps no such buffer.
DEPARTURES = {"h264-cavlc-I-1", "h264-cavlc-P-2", "h264-cavlc-B-2"}


def assert_concealed_as_ffmpeg(path, clean, case=""):
    """The port's frames of ``path`` are FFmpeg's one-thread decode of it,
    every plane; cv2 gives as many, and those the damage leaves equal to the
    undamaged file's (``clean``) decode are cv2's Y.  A case of
    ``DEPARTURES`` is held to all of that but the concealed frames, which
    must still differ.  Returns the port's counters."""
    want = libavformat_planes(path)
    whole = libavformat_planes(clean)
    got, stats = _port(path)
    theirs = _cv2_ys(path)
    assert len(got) == len(want) == len(theirs) > 0
    for k, (r, w) in enumerate(zip(want, whole)):
        if all(np.array_equal(a, b) for a, b in zip(r, w)):
            np.testing.assert_array_equal(got[k][0], theirs[k], err_msg=f"frame {k} (undamaged)")
            np.testing.assert_array_equal(got[k][0], r[0], err_msg=f"frame {k} (undamaged)")
    same = [all(np.array_equal(g[c], r[c]) for c in range(3)) for g, r in zip(got, want)]
    if case in DEPARTURES:
        assert not all(same), f"{case} now equals libavcodec: take it off DEPARTURES"
        return stats
    for k, (g, r) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c], err_msg=f"frame {k} plane {c}")
    return stats


# ------------------------------------------------------------------ streams

def _mp4v_simple(path, frames=13):
    """cv2's writer's stream (the port's, to the bit): an I-VOP every 12."""
    with AVIWriter(path, 96, 64) as w:
        for f in _smooth(frames, 64, 96):
            w.write(f)
    return _samples(path), [0 if i % 12 == 0 else 1 for i in range(frames)]


ASP = dict(width=96, height=64, frames=14, packets=1, bframes=2, four_mv=30, qpel=1,
           mpeg_quant=1, seed=5)


def _mp4v_asp(path, **over):
    """Advanced Simple with video packets, B-VOPs, 4MV, quarter samples and
    MPEG quantisation (XviD's fourcc)."""
    st = mpeg4_writer.exercise(intra=0, **{**ASP, **over})
    mpeg4_writer.to_avi(st, path)
    return _samples(path), list(st.types)


def _h264(path, cabac, slices=1, width=64, height=48, frames=9, bframes=2, seed=3):
    stream = h264_writer.exercise(frames=frames, width=width, height=height, seed=seed,
                                  cabac=cabac, bframes=bframes, slices=slices, idr_every=0)
    aus = [list(au) for au in h264.access_units(h264.nal_units(stream))]
    _mux_h264(path, aus, width, height)
    return aus


def _mux_h264(path, aus, width, height):
    with avi.Muxer(path, width, height, b"H264") as m:
        for au in aus:
            m.add(h264.annexb(au), True)


def _slice_type(nal):
    """slice_type % 5 of a slice NAL unit (0 P, 1 B, 2 I)."""
    bits = "".join(f"{b:08b}" for b in nal[1:9])
    pos = 0

    def ue():
        nonlocal pos
        z = 0
        while bits[pos] == "0":
            z, pos = z + 1, pos + 1
        v = int(bits[pos + 1:pos + 1 + z] or "0", 2) + (1 << z) - 1
        pos += 1 + z
        return v

    ue()
    return ue() % 5


def _au_type(au):
    return next(_slice_type(n) for n in au if n[0] & 0x1F in (1, 5))


def _damage(data: bytes, lo: int, seed: int) -> bytes:
    """3-40 bytes replaced from a seed, past ``lo`` (the headers)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 41))
    n = max(3, min(n, (len(data) - lo) // 3))
    at = int(rng.integers(lo, len(data) - n))
    out = bytearray(data)
    out[at:at + n] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(out)


def _pick(types, want):
    """The damaged picture: the middle one of the type past the first, or
    the first (a stream's only I picture)."""
    idx = [i for i, t in enumerate(types) if t == want and i > 0] or [types.index(want)]
    return idx[len(idx) // 2]


# ------------------------------------------------------------------ mp4v

MP4V_TYPES = {"I": 0, "P": 1, "B": 2}


def _mux_mp4v(path, samples, types, tag):
    with avi.Muxer(path, 96, 64, tag) as m:
        for s, t in zip(samples, types):
            m.add(s, t == 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind,pic", [("simple", "I"), ("simple", "P"), ("asp", "I"), ("asp", "P"),
                                      ("asp", "B")])
def test_mp4v_damaged_packet_is_concealed(tmp_path, kind, pic, seed):
    src = str(tmp_path / "v.avi")
    clean, types = _mp4v_simple(src) if kind == "simple" else _mp4v_asp(src)
    k = _pick(types, MP4V_TYPES[pic])
    samples = list(clean)
    # past the VOP header (and the in-band VOS/VOL of an I-VOP)
    lo = samples[k].rfind(b"\x00\x00\x01\xb6") + 12
    samples[k] = _damage(samples[k], lo, seed)
    bad = str(tmp_path / "bad.avi")
    _mux_mp4v(bad, samples, types, b"FMP4" if kind == "simple" else b"XVID")
    stats = assert_concealed_as_ffmpeg(bad, src, f"mp4v-{kind}-{pic}-{seed}")
    assert stats["damaged_vops"] >= 1 and stats["concealed_mbs"] > 0


@pytest.mark.parametrize("kind,pic", [("simple", "I"), ("simple", "P"), ("asp", "I"), ("asp", "P"),
                                      ("asp", "B")])
def test_mp4v_cut_mid_chunk_is_concealed(tmp_path, kind, pic):
    """A recording cut by the end of the file in the middle of a picture's
    chunk, its sizes already written: the partial chunk is decoded to its
    end and the rest concealed."""
    src = str(tmp_path / "v.avi")
    clean, types = _mp4v_simple(src) if kind == "simple" else _mp4v_asp(src)
    k = _pick(types, MP4V_TYPES[pic])
    d = avi.Demuxer(src)
    off, size = d.offsets[k], d.sizes[k]
    d.close()
    bad = tmp_path / "cut.avi"
    bad.write_bytes(open(src, "rb").read()[:off + size // 2])
    samples = _samples(str(bad))
    assert len(samples) == k + 1 and len(samples[-1]) == size // 2
    assert_concealed_as_ffmpeg(str(bad), src, f"mp4v-cut-{kind}-{pic}")


def test_mp4v_dropped_packet_is_concealed(tmp_path):
    """One video packet of a P-VOP left out: the next packet's resync
    marker is found, the missing macroblocks concealed."""
    src = str(tmp_path / "v.avi")
    clean, types = _mp4v_asp(src, packets=25)

    def markers(vop):
        # resync markers: byte aligned after stuffing, 16 or more zeros then a 1
        start = vop.rfind(b"\x00\x00\x01\xb6") + 4
        return [i for i in range(start + 4, len(vop) - 3)
                if vop[i] == 0 and vop[i + 1] == 0 and vop[i + 2] > 3 and vop[i - 1] != 0]

    k = next(i for i, t in enumerate(types) if t == 1 and len(markers(clean[i])) >= 2)
    vop, marks = clean[k], markers(clean[k])
    samples = list(clean)
    samples[k] = vop[:marks[0]] + vop[marks[1]:]
    bad = str(tmp_path / "bad.avi")
    _mux_mp4v(bad, samples, types, b"XVID")
    stats = assert_concealed_as_ffmpeg(bad, src)
    assert stats["concealed_mbs"] > 0 and stats["resyncs"] == 0


@pytest.mark.parametrize("which", ["first", "second"])
def test_mp4v_damaged_divx_packed_sample_is_concealed(tmp_path, which):
    """DivX's packed samples (a P-VOP and the B-VOP FFmpeg stashes for the
    next sample): damage in the first VOP can cost the stashed B-VOP (its
    sample then gives one frame fewer, as FFmpeg's), damage in the second
    is concealed when its turn comes."""
    st = mpeg4_writer.exercise(seed=1, width=96, height=64, frames=10, bframes=1,
                               user=mpeg4_writer.DIVX, build=1393)
    src = str(tmp_path / "v.avi")
    mpeg4_writer.to_avi(st, src, b"DX50")
    samples = list(st.samples)
    ks = [i for i, s in enumerate(samples) if s.count(b"\x00\x00\x01\xb6") >= 2]
    k = ks[len(ks) // 2]
    vop = samples[k]
    second = vop.find(b"\x00\x00\x01\xb6", vop.find(b"\x00\x00\x01\xb6") + 4)
    lo, hi = (second + 12, len(vop)) if which == "second" else (vop.find(b"\x00\x00\x01\xb6") + 12,
                                                                 second)
    samples[k] = vop[:lo] + _damage(vop[lo:hi], 0, 7) + vop[hi:]
    bad = str(tmp_path / "bad.avi")
    with avi.Muxer(bad, 96, 64, b"DX50") as m:
        for s, key in zip(samples, st.keys):
            m.add(s, key)
    stats = assert_concealed_as_ffmpeg(bad, src)
    assert stats["packed_b_vops"] > 0 and stats["concealed_mbs"] > 0


# ------------------------------------------------------------------ H.264

H264_TYPES = {"I": 2, "P": 0, "B": 1}


def _codec(cabac):
    return "cabac" if cabac else "cavlc"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pic", ["I", "P", "B"])
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_damaged_slice_is_concealed(tmp_path, cabac, pic, seed):
    src = str(tmp_path / "v.avi")
    aus = _h264(src, cabac, frames=13, seed=seed + 1)
    k = _pick([_au_type(au) for au in aus], H264_TYPES[pic])
    au = list(aus[k])
    j = next(i for i, n in enumerate(au) if n[0] & 0x1F in (1, 5))
    au[j] = _damage(au[j], max(8, len(au[j]) // 4), seed)
    aus[k] = au
    bad = str(tmp_path / "bad.avi")
    _mux_h264(bad, aus, 64, 48)
    assert_concealed_as_ffmpeg(bad, src, f"h264-{_codec(cabac)}-{pic}-{seed}")


@pytest.mark.parametrize("pic", ["I", "P", "B"])
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_cut_mid_chunk_is_concealed(tmp_path, cabac, pic):
    src = str(tmp_path / "v.avi")
    aus = _h264(src, cabac, frames=13)
    k = _pick([_au_type(au) for au in aus], H264_TYPES[pic])
    d = avi.Demuxer(src)
    off, size = d.offsets[k], d.sizes[k]
    d.close()
    bad = tmp_path / "cut.avi"
    bad.write_bytes(open(src, "rb").read()[:off + size // 2])
    assert len(_samples(str(bad))) == k + 1
    stats = assert_concealed_as_ffmpeg(str(bad), src, f"h264-cut-{_codec(cabac)}-{pic}")
    assert stats["concealed_mbs"] > 0


@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_dropped_slice_is_concealed(tmp_path, cabac):
    """The second slice of a P picture of several left out: the missing
    macroblocks are concealed from their neighbours' vectors (guess_mv)."""
    src = str(tmp_path / "v.avi")
    aus = _h264(src, cabac, slices=4, width=96, height=64, frames=8, bframes=0)
    slices = [[i for i, n in enumerate(au) if n[0] & 0x1F in (1, 5)] for au in aus]
    k = next(i for i, au in enumerate(aus) if i > 0 and len(slices[i]) >= 2)
    au = list(aus[k])
    del au[slices[k][1]]
    aus[k] = au
    bad = str(tmp_path / "bad.avi")
    _mux_h264(bad, aus, 96, 64)
    stats = assert_concealed_as_ffmpeg(bad, src)
    assert stats["concealed_mbs"] > 0 and stats["damaged_pictures"] == 1


@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_frame_num_gap_is_filled(tmp_path, cabac):
    """A reference picture left out: the next picture's frame_num jumps, and
    the gap is filled as FFmpeg fills it (a frame that copies the newest
    reference, not output), the pictures after it decoded from that."""
    src = str(tmp_path / "v.avi")
    aus = _h264(src, cabac, frames=8, bframes=0)
    del aus[3]
    bad = str(tmp_path / "gap.avi")
    _mux_h264(bad, aus, 64, 48)
    want = libavformat_planes(bad)
    got, stats = _port(bad)
    theirs = _cv2_ys(bad)
    assert len(got) == len(want) == len(theirs) == len(aus)
    for k, (g, r) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c], err_msg=f"frame {k} plane {c}")
        np.testing.assert_array_equal(g[0], theirs[k], err_msg=f"frame {k}")
    assert stats["gap_frames"] == 1


@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_annexb_stream_cut_mid_nal(tmp_path, cabac):
    """A raw ``.h264`` stream cut in the middle of its last slice: the cut
    NAL unit reads into zero padding and the rest is concealed."""
    stream = h264_writer.exercise(frames=8, width=64, height=48, seed=7, cabac=cabac)
    aus = [list(au) for au in h264.access_units(h264.nal_units(stream))]
    last = aus[-1]
    j = max(i for i, n in enumerate(last) if n[0] & 0x1F in (1, 5))
    cut = len(stream) - len(last[j]) // 2
    src, path = tmp_path / "whole.h264", tmp_path / "cut.h264"
    src.write_bytes(stream)
    path.write_bytes(stream[:cut])
    stats = assert_concealed_as_ffmpeg(str(path), str(src))
    assert stats["concealed_mbs"] > 0


# ------------------------------------------------------------------ 720p

import conceal_clips  # noqa: E402

with open(os.path.join(DATA, "conceal_sha256.json")) as _f:
    CLIP_DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(conceal_clips.CLIPS))
def test_720p_damaged_clip_gives_ffmpegs_digests(tmp_path, name):
    """The damaged 720p clips of ``chip_smoke.py``'s concealment part (a P
    and a B picture hit, a slice or packet of another P dropped, the last
    chunk cut) give the committed digests of FFmpeg's one-thread decode,
    frame count and Y; the concealment counters show each damage."""
    path = str(tmp_path / name)
    hit = conceal_clips.CLIPS[name](path)
    want = CLIP_DIGESTS[name]
    assert hit == want["damaged"]
    got, stats = _port(path)
    assert len(got) == want["frames"]
    assert [hashlib.sha256(np.ascontiguousarray(g[0]).tobytes()).hexdigest()
            for g in got] == want["y_sha256"]
    damaged = stats.get("damaged_pictures", stats.get("damaged_vops"))
    assert damaged >= 4 and stats["concealed_mbs"] > 0


# ------------------------------------------------------------------ MP4

@pytest.mark.parametrize("codec", ["mp4v", "h264-cavlc", "h264-cabac"])
def test_mp4_with_its_mdat_cut_reads_as_cv2(tmp_path, codec):
    """An MP4 whose moov precedes an mdat cut by the end of the file (a
    recording cut short): FFmpeg reads the samples that start in the file,
    the last as far as it goes.  An ``mp4v`` sample is decoded and
    concealed; an H.264 sample whose NAL unit runs past the cut fails as a
    whole, and cv2's frame-threaded decode loses the frame before it too:
    cv2's frames and count, the rest FFmpeg's one-thread decode."""
    src, bad = str(tmp_path / "whole.mp4"), tmp_path / "cut.mp4"
    if codec == "mp4v":
        st = mpeg4_writer.exercise(frames=10, seed=4, bframes=2)
        mpeg4_writer.to_mp4(st, src, moov_first=True)
    else:
        stream = h264_writer.exercise(frames=10, width=64, height=48, seed=5, bframes=2,
                                      cabac=codec.endswith("cabac"))
        h264_writer.to_mp4(stream, src, moov_first=True)
    from adas_tpu_torch.render import mp4

    d = mp4.Demuxer(src)
    off, size = d.track.offsets[6], d.track.sizes[6]
    d.close()
    bad.write_bytes(open(src, "rb").read()[:off + size // 2])
    got, stats = _port(str(bad))
    theirs = _cv2_ys(str(bad))
    want = libavformat_planes(str(bad))
    assert len(got) == len(theirs) == (7 if codec == "mp4v" else 5)
    for k, (g, t) in enumerate(zip(got, theirs)):
        np.testing.assert_array_equal(g[0], t, err_msg=f"frame {k}")
        for c in range(3):
            np.testing.assert_array_equal(g[c], want[k][c], err_msg=f"frame {k} plane {c}")
    if codec == "mp4v":
        assert stats["concealed_mbs"] > 0
