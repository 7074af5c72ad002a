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


# ------------------------------------------------------------------ headers

def _escape(rbsp: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _unescape(payload: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in payload:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _with_pps_id(nal: bytes, pps_id: int) -> bytes:
    """A slice NAL unit with its pic_parameter_set_id rewritten: the header
    a damaged byte leaves pointing at a parameter set never sent."""
    bits = "".join(f"{b:08b}" for b in _unescape(nal[1:]))
    pos = 0

    def ue():
        nonlocal pos
        z = 0
        while bits[pos] == "0":
            z, pos = z + 1, pos + 1
        pos += 1 + z

    ue()
    ue()
    start = pos
    ue()
    v = pps_id + 1
    new = "0" * (v.bit_length() - 1) + f"{v:b}"
    bits = bits[:start] + new + bits[pos:]
    bits += "0" * (-len(bits) % 8)
    rbsp = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return nal[:1] + _escape(rbsp)


def _annexb_case(tmp_path, name, aus):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(b"".join(h264.annexb(au) for au in aus))
    return path


def assert_reads_as_cv2(path):
    """The port's frames of ``path`` are cv2's (count and Y) and FFmpeg's
    one-thread decode (every plane).  Returns the port's counters."""
    want = libavformat_planes(path)
    got, stats = _port(path)
    theirs = _cv2_ys(path)
    assert len(got) == len(want) == len(theirs) > 0
    for k, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], theirs[k], err_msg=f"frame {k}")
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c], err_msg=f"frame {k} plane {c}")
    return stats


NON_IDR = {"p": {}, "refs3": {"refs": 3}, "b": {"bframes": 2}, "intra": {"intra_in_p": 100}}


@pytest.mark.parametrize("start", [1, 2])
@pytest.mark.parametrize("kind", sorted(NON_IDR))
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_stream_starting_without_idr_reads_as_cv2(tmp_path, cabac, kind, start):
    """A clip cut from a longer recording without re-encoding: it starts at
    a non-IDR picture.  FFmpeg fills the missing references gray and
    outputs from its recovery point on (the next IDR picture, or an I
    picture its marking heuristic takes); cv2's count and frames."""
    stream = h264_writer.exercise(frames=12, width=64, height=48, seed=start + 2 * cabac,
                                  cabac=cabac, idr_every=6, **NON_IDR[kind])
    aus = [list(au) for au in h264.access_units(h264.nal_units(stream))]
    params = [n for n in aus[0] if n[0] & 0x1F in (7, 8)]
    cut = [params + aus[start]] + aus[start + 1:]
    stats = assert_reads_as_cv2(_annexb_case(tmp_path, "cut.h264", cut))
    assert stats["idr_pictures"] == 1 and stats["unrecovered_pictures"] > 0


def _with_ue(nal: bytes, skip_bits: int, skip_ues: int, value: int) -> bytes:
    """A NAL unit with the Exp-Golomb field after ``skip_bits`` bits and
    ``skip_ues`` fields of its RBSP rewritten to ``value``."""
    bits = "".join(f"{b:08b}" for b in _unescape(nal[1:]))
    pos = skip_bits

    def ue():
        nonlocal pos
        z = 0
        while bits[pos] == "0":
            z, pos = z + 1, pos + 1
        pos += 1 + z

    for _ in range(skip_ues):
        ue()
    start = pos
    ue()
    v = value + 1
    bits = bits[:start] + "0" * (v.bit_length() - 1) + f"{v:b}" + bits[pos:]
    bits += "0" * (-len(bits) % 8)
    return nal[:1] + _escape(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))


#: a parameter set FFmpeg refuses: an SPS id past 31, a PPS naming an SPS
#: never sent, or the unit lost
PARAM_DAMAGE = {
    "sps-id": lambda n: _with_ue(n, 24, 0, 40) if n[0] & 0x1F == 7 else n,
    "pps-sps-id": lambda n: _with_ue(n, 0, 1, 5) if n[0] & 0x1F == 8 else n,
    "pps-missing": lambda n: None if n[0] & 0x1F == 8 else n,
}


def _params_case(tmp_path, cabac, damage, at):
    """The exerciser's stream with its SPS and PPS sent again before the
    second IDR picture, the units of access unit ``at`` damaged."""
    stream = h264_writer.exercise(frames=12, width=64, height=48, seed=4, cabac=cabac,
                                  idr_every=6)
    aus = [list(au) for au in h264.access_units(h264.nal_units(stream))]
    params = [n for n in aus[0] if n[0] & 0x1F in (7, 8)]
    aus[6] = params + aus[6]
    aus[at] = [m for m in map(PARAM_DAMAGE[damage], aus[at]) if m is not None]
    bad = str(tmp_path / "bad.avi")
    _mux_h264(bad, aus, 64, 48)
    return bad


@pytest.mark.parametrize("damage", ["sps-id", "pps-sps-id"])
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_damaged_parameter_set_copy_is_skipped(tmp_path, cabac, damage):
    """A copy of the SPS or PPS sent again mid-stream and damaged: FFmpeg
    skips it and the IDR picture after it decodes with the set before; cv2
    reads every frame."""
    stats = assert_reads_as_cv2(_params_case(tmp_path, cabac, damage, 6))
    assert stats["skipped_headers"] == 1 and stats["pictures"] == 12


@pytest.mark.parametrize("damage", sorted(PARAM_DAMAGE))
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_unreadable_first_packet_ends_the_read(tmp_path, cabac, damage):
    """The stream's first SPS or PPS damaged or lost: no slice of the first
    packet can be read, FFmpeg refuses the packet ("no frame!") and cv2's
    reading ends there, before any frame, though the sets come again later
    (FFmpeg on one thread would read on from them).  The port gives cv2's
    none, at the container's size."""
    bad = _params_case(tmp_path, cabac, damage, 0)
    assert len(_cv2_ys(bad)) == 0 and len(libavformat_planes(bad)) == 6
    with open_reader(bad) as r:
        assert r.read_planes() is None and (r.width, r.height) == (64, 48)
        assert r.stats()["skipped_headers"] >= 1


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("cabac", [0, 1], ids=["cavlc", "cabac"])
def test_h264_damaged_slice_header_is_skipped(tmp_path, cabac, slices):
    """A P picture's slice header damaged so that it names a PPS never sent:
    FFmpeg skips the slice.  With other slices in the picture, they are
    decoded and the skipped one is concealed, and cv2 reads on (FFmpeg's
    one-thread planes, cv2's count, cv2's Y where the damage does not
    reach).  A picture of one slice leaves a packet FFmpeg refuses, and
    cv2's reading ends there: the frames before it."""
    src = str(tmp_path / "v.avi")
    aus = _h264(src, cabac, slices=slices, width=96, height=64, frames=8, bframes=0, seed=6)
    k = _pick([_au_type(au) for au in aus], H264_TYPES["P"])
    au = list(aus[k])
    j = [i for i, n in enumerate(au) if n[0] & 0x1F in (1, 5)][-1]
    au[j] = _with_pps_id(au[j], 7)
    aus[k] = au
    bad = str(tmp_path / "bad.avi")
    _mux_h264(bad, aus, 96, 64)
    if slices > 1:
        stats = assert_concealed_as_ffmpeg(bad, src)
        assert stats["skipped_headers"] == 1 and stats["concealed_mbs"] > 0
        return
    got, stats = _port(bad)
    theirs, whole = _cv2_ys(bad), libavformat_planes(src)
    assert 0 < len(got) == len(theirs) <= k and stats["skipped_headers"] == 1
    for i, (g, t) in enumerate(zip(got, theirs)):
        np.testing.assert_array_equal(g[0], t, err_msg=f"frame {i}")
        for c in range(3):
            np.testing.assert_array_equal(g[c], whole[i][c], err_msg=f"frame {i} plane {c}")


def _vop_fields(vop: bytes, time_bits: int = 5):
    """Bit offsets of a P-VOP's header fields (cv2's writer: no interlace,
    ``time_bits`` of vop_time_increment)."""
    bits = "".join(f"{b:08b}" for b in vop[:16])
    assert bits[:32] == f"{0x1B6:032b}" and bits[32:34] == "01"
    pos = 34
    while bits[pos] == "1":
        pos += 1
    marker1 = pos + 1
    marker2 = marker1 + 1 + time_bits
    quant = marker2 + 1 + 1 + 1 + 3  # vop_coded, rounding, intra_dc_vlc_thr
    assert bits[marker1] == bits[marker2] == "1" and bits[quant:quant + 5] == "00100"
    return {"marker": marker2, "quant": quant, "fcode": quant + 5}


def _set_bits(data: bytes, at: int, value: str) -> bytes:
    bits = list("".join(f"{b:08b}" for b in data))
    bits[at:at + len(value)] = value
    s = "".join(bits)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


VOP_DAMAGE = {"quant0": ("quant", "00000"), "fcode0": ("fcode", "000"),
              "marker": ("marker", "0")}


@pytest.mark.parametrize("damage", sorted(VOP_DAMAGE))
def test_mp4v_damaged_vop_header_reads_as_cv2(tmp_path, damage):
    """A P-VOP header damaged.  vop_quant or vop_fcode_forward 0 is FFmpeg's
    "header damaged": it refuses the packet and cv2's reading ends there,
    with the frames before it.  A missing marker after vop_time_increment
    only makes FFmpeg guess the field's width from the bits that follow,
    and keep it: cv2 reads on.  cv2's count and Y, FFmpeg's planes."""
    src = str(tmp_path / "v.avi")
    samples, types = _mp4v_simple(src, frames=14)
    k = [i for i, t in enumerate(types) if t == 1][3]
    field, value = VOP_DAMAGE[damage]
    samples[k] = _set_bits(samples[k], _vop_fields(samples[k])[field], value)
    bad = str(tmp_path / "bad.avi")
    _mux_mp4v(bad, samples, types, b"FMP4")
    got, stats = _port(bad)
    theirs = _cv2_ys(bad)
    want = libavformat_planes(bad)[:len(theirs)]
    assert len(got) == len(theirs) == len(want) > 0
    for i, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], theirs[i], err_msg=f"frame {i}")
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c], err_msg=f"frame {i} plane {c}")
    if damage == "marker":
        assert stats["time_bits_guessed"] == 1
    else:
        assert stats["damaged_headers"] == 1 and len(got) == k


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
