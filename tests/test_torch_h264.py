"""The port's H.264 decoder (``native/h264.cpp`` through ``render/h264.py``
and ``render/video.MP4Reader`` / ``AnnexBReader``) against cv2's FFmpeg, on
the CPU.

The streams come from ``tests/data/video/h264_writer.cpp``, a writer of
legal I/P/B syntax from a seed that shares the decoder's syntax layer;
cv2 is the independent judge of what the two share.

* Luma: on exerciser streams over a grid of tools x {CAVLC, CABAC} x
  seeds, the port gives cv2's frame count in cv2's order and every Y plane
  to the bit (``cv2.VideoCapture`` with ``CAP_PROP_CONVERT_RGB`` 0 returns
  the decoded luma plane); the decoder's counters show each case uses its
  tool.  So does the content clip (an I_PCM IDR of a real frame, then P
  pictures of a quarter-sample pan, or IBBBP with a B pyramid).
* Output order and count: the port follows FFmpeg's reorder delay (its
  stream probe, the VUI's max_num_reorder_frames, the delay's growth) and
  drops the B pictures FFmpeg drops; spliced streams hold where the
  probe's reach ends.
* Chroma, exactly: an I_PCM stream carries any I420 frame without loss,
  so cv2's BGR of the original stream equals cv2's BGR of the port's
  decoded planes re-wrapped as I_PCM exactly when the port's chroma is
  FFmpeg's.  The carrier is sensitive: one chroma level moved changes
  cv2's BGR.  The same carrier holds the ``mp4v`` decoder's chroma.
* Inputs: Annex B and ``avc1`` / ``avc3`` MP4 (NAL lengths of 1, 2 and 4
  bytes) give the same frames, and cv2 reads the MP4s alike.
* Refusals: every tool the decoder does not take raises ``ValueError``
  naming it; truncated and mutated streams decode or raise ``ValueError``,
  in a child process that must not crash.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "video")
sys.path.insert(0, DATA)

import h264_writer as hw  # noqa: E402

from adas_tpu_torch.ops.preprocess import bgr_to_i420  # noqa: E402
from adas_tpu_torch.render import h264  # noqa: E402
from adas_tpu_torch.render.image import imread  # noqa: E402
from adas_tpu_torch.render.video import (AnnexBReader, MP4Reader,  # noqa: E402
                                         open_reader)

#: exerciser cases: options, and the decoder counter that shows the tool ran
TOOLS = {
    "intra4x4": (dict(frames=1, mb_types=3, pcm=0), "i4x4"),
    "intra8x8": (dict(frames=1, mb_types=4, pcm=0), "i8x8"),
    "intra16x16": (dict(frames=1, mb_types=2), "i16x16"),
    "pcm": (dict(frames=2, pcm=40), "ipcm"),
    "p_partitions": (dict(frames=3, skip=0, intra_in_p=0, t8x8=0, refs=2),
                     "sub_partitions_below_8x8"),
    "p_skip": (dict(frames=3, skip=70), "pskip"),
    "inter_8x8_transform": (dict(frames=3, skip=0, intra_in_p=0), "inter_8x8_transform"),
    "slices": (dict(frames=2, slices=6), "pictures"),
    "deblocking_controls": (dict(frames=3, slices=4, deblock=2),
                            "deblocking_slice_edge_off_slices"),
    "deblocking_off": (dict(frames=2, deblock=3), "deblocking_off_slices"),
    "ref_list_modification": (dict(frames=5, refs=4, ref_mods=1), "ref_list_modifications"),
    "mmco_long_term": (dict(frames=20, refs=3, mmco=1, long_term=1), "long_term_marks"),
    "mmco5": (dict(frames=10, refs=2, mmco=2), "mmco5"),
    "weighted": (dict(frames=4, refs=2, weighted=1), "weighted_slices"),
    "scaling_lists": (dict(frames=3, scaling=2), "scaling_matrix_pictures"),
    "constrained_intra": (dict(frames=3, cip=1, intra_in_p=40), "constrained_intra_pictures"),
    "poc_type_1": (dict(frames=10, poc_type=1, nonref=1), "non_reference_pictures"),
    "poc_type_2": (dict(frames=10, poc_type=2, nonref=1), "non_reference_pictures"),
    "poc_lsb_wrap": (dict(frames=12, nonref=1, log2_poc_lsb=4), "non_reference_pictures"),
    "large_levels": (dict(frames=2, big_levels=1, qp_min=0, qp_max=12), "pictures"),
    "cropping_vui_idr": (dict(frames=6, width=100, height=58, vui=1, idr_every=3),
                         "cropped_pictures"),
    "main_profile": (dict(frames=3, profile=77, t8x8=0), "pictures"),
    # B pictures
    "b_mb_types": (dict(frames=8, bframes=2, b_types=3, skip=0, intra_in_p=0, refs=2), "b16x8"),
    "b_8x8_sub_types": (dict(frames=8, bframes=2, b_types=1, skip=0, intra_in_p=0),
                        "b_sub_partitions_below_8x8"),
    "b_skip_and_direct_16x16": (dict(frames=8, bframes=2, b_types=2, skip=50), "bskip"),
    "spatial_direct": (dict(frames=8, bframes=2, direct=0, b_types=2, skip=30),
                       "spatial_direct_slices"),
    "temporal_direct": (dict(frames=10, bframes=2, direct=1, b_types=2, refs=3),
                        "temporal_direct_slices"),
    "direct_4x4": (dict(frames=8, bframes=2, direct=2, direct_4x4=1, b_types=2), "direct_4x4_mbs"),
    "implicit_weights": (dict(frames=8, bframes=2, bipred=2, refs=3, b_types=3),
                         "implicit_weight_slices"),
    "explicit_bi_weights": (dict(frames=8, bframes=2, bipred=1, refs=3, b_types=3),
                            "explicit_bipred_slices"),
    "list1_modification": (dict(frames=10, bframes=2, refs=4, ref_mods=1), "ref_list1_modifications"),
    "long_term_in_b_lists": (dict(frames=16, bframes=2, refs=3, mmco=1, long_term=1),
                             "b_mbs_from_long_term"),
    "b_pyramid": (dict(frames=12, bframes=3, pyramid=1), "reference_b_pictures"),
    "b_vui_reorder": (dict(frames=12, bframes=3, pyramid=1, vui=1), "b_slices"),
    "b_without_vui": (dict(frames=12, bframes=3, pyramid=1, idr_every=6), "b_slices"),
    "b_slices_and_intra": (dict(frames=8, bframes=2, slices=4, intra_in_p=30), "bi_predicted_mbs"),
}
ENTROPY = {"cavlc": 0, "cabac": 1}


def _cv2_frames(path, convert_rgb=False):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 1 if convert_rgb else 0)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.copy())
    cap.release()
    return frames


def _port(stream):
    """(frames, counters) of an Annex B stream, an access unit at a time,
    from the reorder delay of FFmpeg's probe (as cv2 decodes a file)."""
    aus = [h264.annexb(au) for au in h264.access_units(h264.nal_units(stream))]
    d = h264.Decoder(None, h264.probe_delay(aus))
    frames = []
    for au in aus:
        frames += d.decode(au)
    frames += d.flush()
    stats = d.stats()
    d.close()
    return frames, stats


def _write(tmp_path, stream, name="s.h264"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(stream)
    return path


def _assert_luma(stream, path):
    frames, stats = _port(stream)
    ys = _cv2_frames(path)
    assert len(frames) == len(ys) > 0
    for i, (f, y) in enumerate(zip(frames, ys)):
        h = f.shape[0] * 2 // 3
        np.testing.assert_array_equal(f[:h], y.reshape(h, f.shape[1]), err_msg=f"frame {i}")
    return frames, stats


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("entropy", list(ENTROPY))
@pytest.mark.parametrize("tool", list(TOOLS))
def test_luma_equals_cv2(tmp_path, tool, entropy, seed):
    options, counter = TOOLS[tool]
    stream = hw.exercise(seed=seed, cabac=ENTROPY[entropy], **options)
    _, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert stats[counter] > 0, (counter, stats)
    assert stats["cabac_slices" if ENTROPY[entropy] else "cavlc_slices"] > 0


def _frame_720p():
    return bgr_to_i420(imread(os.path.join(REPO, "tests", "data", "images", "frame_720p.png")))


def _crop(i420, h, w, y0=0, x0=0):
    """A (h, w) window of a 720p frame's I420 planes (y0, x0 even)."""
    y, u, v = i420[:720], i420[720:900].reshape(360, 640), i420[900:].reshape(360, 640)
    return np.concatenate([y[y0:y0 + h, x0:x0 + w],
                           u[y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2].reshape(-1, w),
                           v[y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2].reshape(-1, w)])


@pytest.mark.parametrize("cabac", [False, True])
def test_content_clip(tmp_path, cabac):
    """An I_PCM IDR of a real frame, then P pictures panning 5/4 and 3/4
    sample a picture: cv2's Y to the bit, and the IDR is the frame."""
    frame = _crop(_frame_720p(), 144, 176, 300, 500)
    stream = hw.content(frame, n_p=5, pan=(5, 3), cabac=cabac)
    frames, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert len(frames) == 6
    np.testing.assert_array_equal(frames[0], frame)
    assert stats["ipcm"] == 99 and stats["pskip"] > 0 and stats["p16x16"] > 0


@pytest.mark.parametrize("cabac", [False, True])
def test_content_clip_with_b_pictures(tmp_path, cabac):
    """The pan coded IBBBP with a B pyramid (B_Bi_16x16, B_Direct_16x16,
    B_Skip; spatial and temporal direct): cv2's Y to the bit, cv2's count
    and order, and the IDR is the frame."""
    frame = _crop(_frame_720p(), 144, 176, 300, 500)
    stream = hw.content(frame, n_p=11, pan=(5, 3), cabac=cabac, bframes=3)
    frames, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert len(frames) == 12
    np.testing.assert_array_equal(frames[0], frame)
    for k in ("bskip", "b_direct_16x16", "b16x16", "reference_b_pictures", "spatial_direct_slices",
              "temporal_direct_slices"):
        assert stats[k] > 0, (k, stats)


def _carrier_bgr(tmp_path, frames):
    """cv2's BGR of I420 frames carried losslessly as I_PCM pictures."""
    return _cv2_frames(_write(tmp_path, hw.content(np.stack(frames)), "carrier.h264"), True)


CHROMA_CASES = ["intra4x4", "intra16x16", "p_partitions", "weighted", "scaling_lists",
                "deblocking_controls", "cropping_vui_idr", "b_mb_types", "b_8x8_sub_types",
                "temporal_direct", "direct_4x4", "implicit_weights", "explicit_bi_weights",
                "b_pyramid"]


@pytest.mark.parametrize("entropy", list(ENTROPY))
@pytest.mark.parametrize("tool", CHROMA_CASES)
def test_chroma_exact_through_pcm_carrier(tmp_path, tool, entropy):
    options, _ = TOOLS[tool]
    stream = hw.exercise(seed=2, cabac=ENTROPY[entropy], **options)
    frames, _ = _port(stream)
    want = _cv2_frames(_write(tmp_path, stream), True)
    got = _carrier_bgr(tmp_path, frames)
    assert len(got) == len(want) == len(frames)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")


def test_carrier_sees_one_chroma_level(tmp_path):
    """The carrier's BGR changes when one chroma sample moves by one level."""
    frame = _crop(_frame_720p(), 48, 64, 200, 200)
    base = _carrier_bgr(tmp_path, [frame])[0]
    for row in (48, 48 + 12):  # a U sample, a V sample
        moved = frame.copy()
        moved[row, 5] = moved[row, 5] + 1 if moved[row, 5] < 255 else 254
        assert not np.array_equal(_carrier_bgr(tmp_path, [moved])[0], base)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(DATA, "*.mp4"))),
                         ids=os.path.basename)
def test_mpeg4_chroma_exact_through_pcm_carrier(tmp_path, path):
    """The ``mp4v`` decoder's chroma is FFmpeg's to the bit: cv2's BGR of
    the fixture equals cv2's BGR of the port's planes as I_PCM."""
    with MP4Reader(path) as r:
        frames = list(r.i420_frames())
    want = _cv2_frames(path, True)
    got = _carrier_bgr(tmp_path, frames)
    assert len(got) == len(want) == len(frames)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")


@pytest.mark.parametrize("cabac", [0, 1])
@pytest.mark.parametrize("fourcc,length_size", [(b"avc1", 4), (b"avc1", 2), (b"avc3", 4),
                                                (b"avc3", 2)])
def test_annexb_and_mp4_give_the_same_frames(tmp_path, cabac, fourcc, length_size):
    stream = hw.exercise(seed=5, cabac=cabac, frames=5, refs=2, slices=3, width=100,
                         height=58, nonref=1)
    frames, _ = _port(stream)
    annexb = _write(tmp_path, stream)
    mp4_path = str(tmp_path / "s.mp4")
    assert hw.to_mp4(stream, mp4_path, fourcc, length_size) == 5
    for path, cls in ((annexb, AnnexBReader), (mp4_path, MP4Reader)):
        with open_reader(path) as r:
            assert isinstance(r, cls) and (r.width, r.height) == (100, 58)
            got = list(r.i420_frames())
        assert len(got) == len(frames)
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)
    ys = _cv2_frames(mp4_path)
    assert len(ys) == len(frames)
    for y, f in zip(ys, frames):
        np.testing.assert_array_equal(y, f[:58])


def test_skipped_nal_units_and_start_codes(tmp_path):
    """AUD, SEI, filler, end-of-sequence, end-of-stream and SVC/MVC NAL
    units are skipped; 3- and 4-byte start codes and trailing zero bytes
    split alike: the frames are the plain stream's.  (The skipped units'
    payloads are placeholders, so cv2 is not the judge here.)"""
    stream = hw.exercise(seed=4, frames=4, cabac=1, slices=2)
    frames, _ = _port(stream)
    extra = {9: b"\x09\x10", 6: b"\x06\x05\x01\x00\x80", 12: b"\x0c\xff\xff\x80",
             14: b"\x6e\x80\x00\x00\x80", 20: b"\x74\x80\x00\x00\x80"}
    out = b""
    for au in h264.access_units(h264.nal_units(stream)):
        out += b"\x00\x00\x00\x01" + extra[9] + b"\x00\x00\x01" + extra[6]
        for nal in au:
            out += b"\x00\x00\x01" + nal + b"\x00\x00"
            if nal[0] & 0x1F in (1, 5):
                out += b"".join(b"\x00\x00\x01" + extra[k] for k in (12, 14, 20))
    out += b"\x00\x00\x01\x0a\x00\x00\x01\x0b"
    got, _ = _port(out)
    assert len(got) == len(frames) and all(np.array_equal(g, f) for g, f in zip(got, frames))
    with AnnexBReader(_write(tmp_path, out)) as r:
        got = list(r.i420_frames())
    assert len(got) == len(frames) and all(np.array_equal(g, f) for g, f in zip(got, frames))


def test_one_byte_nal_lengths_and_rates(tmp_path):
    """NAL lengths of one byte (NAL units under 256 bytes); an MP4's rate
    from its track, a raw stream's from the VUI or 25 (FFmpeg's)."""
    stream = hw.exercise(seed=0, frames=3, width=16, height=16, pcm=0, qp_min=40, qp_max=51,
                         skip=80, intra_in_p=0)
    assert max(len(n) for n in h264.nal_units(stream)) < 256
    frames, _ = _port(stream)
    path = str(tmp_path / "s.mp4")
    hw.to_mp4(stream, path, b"avc1", 1, fps=12.0)
    with MP4Reader(path) as r:
        assert r.fps == 12.0 and r.codec == "avc1"
        got = list(r.i420_frames())
    assert len(got) == len(frames) and all(np.array_equal(g, f) for g, f in zip(got, frames))
    with AnnexBReader(_write(tmp_path, stream)) as r:
        assert r.fps == 25.0
    vui = hw.exercise(seed=0, frames=1, vui=1)
    with AnnexBReader(_write(tmp_path, vui, "vui.h264")) as r:
        assert r.fps == 25.0  # time_scale 50 / (2 * num_units_in_tick 1)
        assert len(list(r)) == 1


# ------------------------------------------------------------------ refusals


class _Bits:
    def __init__(self):
        self.bits = []

    def u(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, v):
        x = v + 1
        return self.u(x.bit_length() - 1, 0).u(x.bit_length(), x)

    def se(self, v):
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def rbsp(self):
        self.u(1, 1).align()
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def _nal(ref_idc, kind, rbsp):
    out, zeros = bytearray([ref_idc << 5 | kind]), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return b"\x00\x00\x00\x01" + bytes(out)


def _sps(profile=66, chroma=1, depth=8, bypass=0, frame_mbs_only=1, mbaff=0, mbs=(1, 1), refs=1):
    b = _Bits().u(8, profile).u(8, 0).u(8, 30).ue(0)
    if profile == 100:
        b.ue(chroma)
        if chroma == 3:
            b.u(1, 0)
        b.ue(depth - 8).ue(depth - 8).u(1, bypass).u(1, 0)
    b.ue(0).ue(0).ue(0).ue(refs).u(1, 0).ue(mbs[0] - 1).ue(mbs[1] - 1).u(1, frame_mbs_only)
    if not frame_mbs_only:
        b.u(1, mbaff)
    return _nal(3, 7, b.u(1, 1).u(1, 0).u(1, 0).rbsp())


def _pps(slice_groups=1, redundant=0):
    b = _Bits().ue(0).ue(0).u(1, 0).u(1, 0).ue(slice_groups - 1)
    if slice_groups > 1:
        b.ue(0).ue(0)
    return _nal(3, 8, b.ue(0).ue(0).u(1, 0).u(2, 0).se(0).se(0).se(0).u(1, 0).u(1, 0)
                .u(1, redundant).rbsp())


def _idr(redundant_cnt=None):
    """An IDR picture of one I_PCM macroblock (16x16)."""
    b = _Bits().ue(0).ue(7).ue(0).u(4, 0).ue(0).u(4, 0)
    if redundant_cnt is not None:
        b.ue(redundant_cnt)
    b.u(1, 0).u(1, 0).se(0).ue(25).align()
    for _ in range(384):
        b.u(8, 128)
    return _nal(3, 5, b.rbsp())


def _p(frame_num, slice_type=5):
    b = _Bits().ue(0).ue(slice_type).ue(0).u(4, frame_num).u(4, 2 * frame_num)
    return _nal(2, 1, b.u(1, 0).u(1, 0).u(1, 0).se(0).ue(1).rbsp())


def _b(frame_num, poc_lsb):
    """A non-reference B picture of one B_Skip macroblock (spatial direct)."""
    b = _Bits().ue(0).ue(6).ue(0).u(4, frame_num).u(4, poc_lsb)
    return _nal(0, 1, b.u(1, 1).u(1, 0).u(1, 0).u(1, 0).se(0).ue(1).rbsp())


VALID = _sps() + _pps() + _idr() + _p(1)
REFUSED = {
    "SP and SI": VALID + _p(2, slice_type=8),
    "field pictures and MBAFF": _sps(frame_mbs_only=0),
    "field pictures and MBAFF ": _sps(frame_mbs_only=0, mbaff=1),
    "chroma_format_idc 2": _sps(profile=100, chroma=2),
    "chroma_format_idc 3": _sps(profile=100, chroma=3),
    "chroma_format_idc 0": _sps(profile=100, chroma=0),
    "bit depth 10/10": _sps(profile=100, depth=10),
    "qpprime_y_zero_transform_bypass": _sps(profile=100, bypass=1),
    "slice groups": _sps() + _pps(slice_groups=2),
    "redundant pictures": _sps() + _pps(redundant=1) + _idr(redundant_cnt=1),
    "data partitioning": VALID + _nal(2, 2, b"\x80"),
    "larger than 33554432 pixels": _sps(mbs=(2048, 1024)),
    "does not start with an IDR": _sps() + _pps() + _p(1),
}


def test_valid_handmade_stream_decodes(tmp_path):
    frames, stats = _assert_luma(VALID, _write(tmp_path, VALID))
    assert len(frames) == 2 and stats["ipcm"] == 1 and stats["pskip"] == 1
    assert (frames[0] == 128).all() and (frames[1] == 128).all()


def test_handmade_b_stream_decodes(tmp_path):
    """Main profile, two reference frames: an IDR (POC 0), a P picture
    (POC 2) and between them a B picture (POC 1) of one B_Skip: cv2's three
    frames."""
    stream = _sps(profile=77, refs=2) + _pps() + _idr() + _p(1) + _b(2, 1)
    frames, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert len(frames) == 3 and stats["b_slices"] == stats["bskip"] == 1
    assert stats["reorder_delay"] == 1 and stats["dropped_pictures"] == 0


#: streams the decoder used to refuse and now reads as FFmpeg does: a
#: stream that does not start with an IDR picture (a clip cut from a longer
#: recording) decodes from gray references, and a picture before FFmpeg's
#: recovery point is not output (``tests/test_torch_conceal.py`` holds
#: such streams to cv2 frame by frame)
READ_NOW = {"does not start with an IDR"}


@pytest.mark.parametrize("tool", list(REFUSED))
def test_refused_tools_raise_by_name(tmp_path, tool):
    if tool in READ_NOW:
        frames, stats = _port(REFUSED[tool])
        assert frames == [] == _cv2_frames(_write(tmp_path, REFUSED[tool]))
        assert stats["pictures"] == 1 and stats["unrecovered_pictures"] == 1
        return
    with pytest.raises(ValueError, match=tool.strip()):
        _port(REFUSED[tool])


def test_refused_tool_propagates_from_the_readers(tmp_path):
    path = _write(tmp_path, REFUSED["SP and SI"])
    with pytest.raises(ValueError, match="SP and SI"):
        with open_reader(path) as r:
            list(r)
    with pytest.raises(ValueError, match="without a sequence parameter set"):
        AnnexBReader(_write(tmp_path, b"\x00\x00\x01\x09\x10", "aud.h264"))


FUZZ_SCRIPT = textwrap.dedent(
    """
    import random, sys
    sys.path.insert(0, "tests/data/video")
    import h264_writer as hw
    from adas_tpu_torch.render import h264

    rng = random.Random(int(sys.argv[1]))
    decoded = refused = 0
    for it in range(int(sys.argv[2])):
        b = it % 4 >= 2
        stream = bytearray(hw.exercise(
            seed=rng.randint(0, 10 ** 6), cabac=it % 2, frames=rng.randint(1, 4) + 3 * b,
            refs=rng.randint(1, 3), ref_mods=1, mmco=1, long_term=1, weighted=rng.randint(0, 1),
            scaling=1, slices=rng.randint(1, 3), deblock=2, nonref=1, pcm=5,
            width=rng.choice([16, 48, 64]), height=rng.choice([16, 32, 48]),
            bframes=rng.randint(1, 3) * b, pyramid=rng.randint(0, 1), direct=2,
            bipred=rng.randint(0, 2), direct_4x4=rng.randint(0, 1)))
        kind = it % 3
        if kind == 0:
            stream = stream[:rng.randint(0, len(stream))]
        else:
            for _ in range(rng.randint(1, 8)):
                i = rng.randrange(len(stream))
                stream[i] = rng.randint(0, 255) if kind == 1 else stream[i] ^ 1 << rng.randint(0, 7)
        d = h264.Decoder(None, rng.randint(0, 2))
        try:
            for au in h264.access_units(h264.nal_units(bytes(stream))):
                d.decode(h264.annexb(au))
            d.flush()
            decoded += 1
        except ValueError:
            refused += 1
        d.close()
    print(decoded, refused)
    """
)


@pytest.mark.parametrize("seed", [1, 2])
def test_truncated_and_mutated_streams_decode_or_raise(seed):
    """Truncated streams and streams with bytes replaced or bits flipped,
    I/P and with B pictures, decode or raise ``ValueError``; the process
    never crashes."""
    proc = subprocess.run([sys.executable, "-c", FUZZ_SCRIPT, str(seed), "150"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoded, refused = map(int, proc.stdout.split())
    assert decoded + refused == 150 and refused > 0


# ------------------------------------------------------------------ fixtures

FIXTURE_DIR = os.path.join(DATA, "h264")
with open(os.path.join(FIXTURE_DIR, "sha256.json")) as _f:
    DIGESTS = json.load(_f)


def _digests(frames):
    return [hashlib.sha256(f[:f.shape[0] * 2 // 3].tobytes()).hexdigest() for f in frames]


@pytest.mark.parametrize("name", [k for k in DIGESTS if not k.startswith("content_720p")])
def test_fixtures_decode_to_cv2_digests(name):
    """The committed H.264 fixtures give cv2's Y planes (committed as
    sha256, and live) at their size and frame count."""
    path = os.path.join(FIXTURE_DIR, name)
    want = DIGESTS[name]
    with open_reader(path) as r:
        assert (r.width, r.height) == (want["width"], want["height"])
        frames = list(r.i420_frames())
    assert _digests(frames) == want["y_sha256"]
    ys = _cv2_frames(path)
    assert [hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"]


def test_content_720p_rebuilds_to_cv2_digests():
    """The 720p content clip rebuilt by the writer decodes to cv2's
    committed digests (what a host without cv2 checks)."""
    frames, stats = _port(hw.content_720p())
    want = DIGESTS["content_720p"]
    assert len(frames) == want["frames"] == 24
    assert _digests(frames) == want["y_sha256"]
    assert stats["cabac_slices"] == 24 and stats["ipcm"] == 3600


def test_content_720p_b_rebuilds_to_cv2_digests():
    """The 720p B clip (the pan as IBBBP with a B pyramid) rebuilt by the
    writer decodes to cv2's committed digests, in cv2's order."""
    frames, stats = _port(hw.content_720p_b())
    want = DIGESTS["content_720p_b"]
    assert len(frames) == want["frames"] == 24
    assert _digests(frames) == want["y_sha256"]
    assert stats["b_slices"] == 17 and stats["reference_b_pictures"] == 6
    assert stats["spatial_direct_slices"] > 0 and stats["temporal_direct_slices"] > 0


# ------------------------------------------------------------------ output order and count


def _spliced(k):
    """An IBP stream of k pictures (reorder depth 1), then a B pyramid
    (depth 2) after a second IDR picture."""
    return (hw.exercise(seed=1, bframes=1, frames=k, width=32, height=32)
            + hw.exercise(seed=2, bframes=3, pyramid=1, frames=13, width=32, height=32))


@pytest.mark.parametrize("k,dropped", [(4, 0), (5, 1)])
def test_ffmpeg_drops_a_picture_its_probe_did_not_reach(tmp_path, k, dropped):
    """FFmpeg's stream probe decodes until 7 frames are out and cv2's
    decoder starts from the reorder delay it reached.  With k = 4 the probe
    sees the pyramid (delay 2); with k = 5 it stops at delay 1, and the
    pyramid's first non-reference B picture (POC 2 after the second IDR),
    decoded after its reference B picture (POC 4) was output, is dropped.
    The port drops the same picture; as an MP4, ``ctts`` shows FFmpeg the
    depth first and nothing is dropped."""
    stream = _spliced(k)
    frames, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert stats["dropped_pictures"] == dropped and len(frames) == k + 13 - dropped
    path = str(tmp_path / "s.mp4")
    hw.to_mp4(stream, path, b"avc3")  # two parameter set pairs: in band
    with open_reader(path) as r:
        got = list(r.i420_frames())
        assert r.stats()["dropped_pictures"] == 0 and len(r) == k + 13
    ys = _cv2_frames(path)
    assert len(got) == len(ys) == k + 13
    for g, y in zip(got, ys):
        np.testing.assert_array_equal(g[:32], y)


def test_missing_reference_entries_reset_the_reorder_count(tmp_path):
    """Slices whose lists are longer than the references (legal while the
    entries past them go unused) make FFmpeg forget its recent POCs, so its
    delay stays at 1 through this pyramid (depth 2) and four B pictures are
    dropped; the port follows (without that reset it would give all 20)."""
    stream = hw.exercise(seed=33, bframes=3, pyramid=1, frames=20, cabac=1, direct=1)
    frames, stats = _assert_luma(stream, _write(tmp_path, stream))
    assert stats["dropped_pictures"] == 4 and len(frames) == 16
    assert stats["reorder_delay"] == 1 and stats["temporal_direct_slices"] > 0
