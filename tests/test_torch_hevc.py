"""The port's H.265 decoder (``native/hevc.cpp`` through ``render/hevc.py``
and ``render/video.MP4Reader`` / ``AVIReader`` / ``AnnexBReader``) against
cv2's FFmpeg, on the CPU.

The streams come from ``tests/data/video/hevc_writer.cpp``, a writer of
legal I/P/B syntax from a seed that shares the decoder's syntax layer; cv2
is the independent judge of what the two share.

* Every tool: on exerciser streams over a grid of tools x seeds, the port
  gives cv2's frame count in cv2's order, Y equal to cv2's
  (``CAP_PROP_CONVERT_RGB`` 0 returns the decoded luma plane) and every
  plane equal to cv2's bundled libavcodec on one thread, read as cv2 reads
  the file (``make_fixtures.libavformat_planes``); each case's counter
  shows its tool ran: x265's default tools among them (hierarchical B
  pictures, weighted prediction), and low-delay B, list 1's modification,
  combined bi-predictive merges, mvd_l1_zero_flag and both co-located
  lists.  So do the 720p content clips (a PCM IDR picture, then P
  pictures of a quarter-sample pan by merge and AMVP; or GOPs of a P
  anchor and three hierarchical B pictures over a luma fade by explicit
  weights), by the digests cv2 made of them.
* Output: FFmpeg's bumping by the SPS's reorder depth and DPB size,
  ``pic_output_flag``, RASL pictures after a CRA picture that starts the
  stream, and a stream that starts without an IRAP picture (a picture
  that refers to a missing reference is not decoded).
* Inputs: Annex B, ``hvc1`` and ``hev1`` MP4 (``ctts`` and ``elst`` for
  B pictures) and AVI give the same frames; the conformance window crops
  as cv2 does.
* Refusals: every tool the decoder does not take raises ``ValueError``
  naming it; truncated and mutated streams decode or raise ``ValueError``,
  in a child process that must not crash.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "video")
sys.path.insert(0, DATA)

import hevc_writer as hw  # noqa: E402
from make_fixtures import libavformat_planes  # noqa: E402

from adas_tpu_torch.render import hevc  # noqa: E402
from adas_tpu_torch.render.video import open_reader  # noqa: E402

#: exerciser cases: options, and the decoder counter that shows the tool ran
TOOLS = {
    "intra": (dict(frames=1, intra_in_p=100), "intra_angular"),
    "ctb32": (dict(ctb=32, tu_depth=2), "ctb32_pictures"),
    "ctb64": (dict(ctb=64, max_tb=5, tu_depth=3, width=136, height=72), "tu32"),
    "min_cb16": (dict(ctb=32, min_cb=16, width=96, height=64), "inter_nxn_cus"),
    "amp": (dict(amp=1, ctb=32), "amp_cus"),
    "intra_nxn": (dict(frames=2, intra_in_p=100, ctb=16), "intra_nxn_cus"),
    "pcm": (dict(pcm=30, intra_in_p=50), "pcm_cus"),
    "pcm_7bit_unfiltered": (dict(pcm=30, pcm_bits=7, pcm_lf=1, intra_in_p=50, sao=1), "pcm_cus"),
    "transform_skip": (dict(tskip=1, intra_in_p=50), "transform_skip_blocks"),
    "sign_hiding": (dict(sign_hiding=1, big_levels=1), "sign_hidden_groups"),
    "cu_qp_delta": (dict(qp_delta=2, ctb=32), "qp_deltas"),
    "cu_qp_delta_wpp": (dict(qp_delta=1, wpp=1, slices=2), "qp_deltas"),
    "cu_qp_delta_edge": (dict(qp_delta=1, ctb=32, width=72, height=40, pcm=10), "qp_deltas"),
    "chroma_qp_offsets": (dict(chroma_qp=1), "chroma_qp_offset_slices"),
    "scaling_default": (dict(scaling=1), "scaling_list_blocks"),
    "scaling_sps": (dict(scaling=2, ctb=32, tu_depth=2), "scaling_list_blocks"),
    "scaling_pps": (dict(scaling=3, ctb=32), "scaling_list_blocks"),
    "constrained_intra": (dict(cip=1, intra_in_p=40), "constrained_intra_pictures"),
    "strong_smoothing": (dict(strong=1, ctb=64, max_tb=5, width=128, height=64, intra_in_p=60),
                         "strong_smoothing"),
    "tmvp": (dict(tmvp=1, refs=2), "tmvp_candidates"),
    "refs4": (dict(refs=4, tmvp=1, list_mod=1, frames=8), "multi_ref_pus"),
    "merge_level": (dict(merge_level=2, max_merge=3, ctb=32), "parallel_merge_pus"),
    "deblocking": (dict(deblock=2, slices=3, across=2), "deblocked_edges"),
    "deblocking_off": (dict(deblock=1), "deblocking_off_slices"),
    "sao": (dict(sao=1, slices=2, across=2), "sao_edge"),
    "wpp": (dict(wpp=1, ctb=16, height=64), "wpp_rows"),
    "wpp_slices": (dict(wpp=1, ctb=16, slices=3, height=96, qp_delta=1), "slices_after_the_first"),
    "cabac_init": (dict(cabac_init=1), "cabac_init_slices"),
    "idr": (dict(idr_every=3, frames=7), "idr_pictures"),
    "cra_rasl": (dict(cra=1, idr_every=3, frames=8, reorder=1), "cra_pictures"),
    "reorder": (dict(reorder=1, refs=2, tmvp=1, frames=8), "reordered_outputs"),
    "pic_output_flag": (dict(output_flag=1, frames=12), "not_output"),
    "sps_rps": (dict(sps_rps=1, refs=3, frames=8), "inter_rps_pictures"),
    "poc_wrap": (dict(log2_poc_lsb=4, frames=20, width=32, height=32), "pictures"),
    "slices": (dict(slices=4, ctb=16), "slices_after_the_first"),
    # B slices and weighted prediction
    "b_flat": (dict(bframes=2, frames=8), "b_slices"),
    "b_pyramid": (dict(bframes=3, pyramid=1, frames=9, tmvp=1), "bi_pus"),
    "b_pyramid_cra_rasl": (dict(bframes=3, pyramid=1, frames=13, cra=1, idr_every=8, tmvp=1),
                           "cra_pictures"),
    "gpb": (dict(gpb=100, refs=2), "l1_pus"),
    "list_mod_l1": (dict(gpb=100, refs=3, list_mod=1, frames=8), "list_modifications_l1"),
    "bi_merge": (dict(gpb=100, refs=2, skip=40, tmvp=1), "combined_bi_merges"),
    "bi_merge_8x4": (dict(bframes=1, frames=7, min_cb=8, ctb=16, bi=90), "bi_merges_to_l0"),
    "mvd_l1_zero": (dict(bframes=3, pyramid=1, frames=9, mvd_l1_zero=100, bi=90), "mvd_l1_zero_pus"),
    "collocated_l0": (dict(bframes=2, frames=8, tmvp=1, col=1, refs=2), "tmvp_l1"),
    "collocated_l1": (dict(bframes=2, frames=8, tmvp=1, col=2, refs=2), "collocated_from_l1_slices"),
    "weighted_p": (dict(wp=1, refs=2), "weighted_pus"),
    "weighted_b": (dict(wp=2, bframes=3, pyramid=1, frames=9, tmvp=1), "weighted_pus"),
    "weighted_wide_offsets": (dict(wp=3, bframes=2, frames=10, refs=3, wp_offsets=40000),
                              "weighted_pus"),
    "b_filters_slices": (dict(bframes=3, pyramid=1, frames=9, deblock=2, slices=3, across=2, sao=1,
                              amp=1, ctb=32), "deblocked_edges"),
}
SEEDS = (0, 1)


def _planes(frame, w, h):
    f = np.asarray(frame).ravel()
    return (f[:w * h].reshape(h, w), f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
            f[w * h * 5 // 4:].reshape(h // 2, w // 2))


def _cv2_ys(path):
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


def _port(path):
    out = []
    with open_reader(path) as r:
        while (planes := r.read_planes()) is not None:
            out.append(_planes(planes, r.width, r.height))
        return out, r.stats(), (r.width, r.height)


def assert_reads_as_cv2(path):
    """The port's frames of ``path``: cv2's count, order and Y, and every
    plane of cv2's libavcodec on one thread.  Returns the counters."""
    got, stats, (w, h) = _port(path)
    ys = _cv2_ys(path)
    want = libavformat_planes(path)
    assert len(got) == len(ys) == len(want) > 0
    for k, (g, y, r) in enumerate(zip(got, ys, want)):
        np.testing.assert_array_equal(g[0], y.reshape(h, w), err_msg=f"frame {k} (cv2)")
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c], err_msg=f"frame {k} plane {c}")
    return stats


def _write(tmp_path, stream, name="s.h265"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(stream)
    return path


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_decodes_as_cv2(tmp_path, tool, seed):
    options, counter = TOOLS[tool]
    stream = hw.exercise(**{"frames": 5, "seed": seed, **options})
    stats = assert_reads_as_cv2(_write(tmp_path, stream))
    assert stats[counter] > 0, (counter, stats)


@pytest.mark.parametrize("container", ["h265", "hvc1", "hev1", "avi"])
def test_containers_give_the_same_frames(tmp_path, container):
    """One stream of many tools as raw Annex B, ``hvc1`` (parameter sets in
    the ``hvcC``), ``hev1`` (in band) and AVI: cv2's frames each time, and
    the same frames."""
    stream = hw.exercise(frames=6, seed=9, ctb=32, amp=1, tmvp=1, refs=2, sao=1, wpp=1,
                         slices=2, qp_delta=1, pcm=10, intra_in_p=20, vui=1)
    if container == "h265":
        path = _write(tmp_path, stream)
    elif container == "avi":
        path = str(tmp_path / "s.avi")
        hw.to_avi(stream, path, b"HEVC")
    else:
        path = str(tmp_path / "s.mp4")
        hw.to_mp4(stream, path, container.encode(), length_size=2 if container == "hev1" else 4)
    assert_reads_as_cv2(path)
    got, _, size = _port(path)
    ref, _, ref_size = _port(_write(tmp_path, stream, "ref.h265"))
    assert size == ref_size and len(got) == len(ref)
    for g, r in zip(got, ref):
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c])


@pytest.mark.parametrize("container", ["h265", "hvc1", "hev1", "avi"])
def test_b_containers_give_the_same_frames(tmp_path, container):
    """A stream of hierarchical B pictures with weighted prediction as raw
    Annex B, ``hvc1`` and ``hev1`` (``ctts`` with the reorder and an
    ``elst`` from the first frame) and AVI: cv2's frames each time, and
    the same frames."""
    from adas_tpu_torch.render import mp4

    stream = hw.exercise(frames=10, seed=4, bframes=3, pyramid=1, tmvp=1, refs=2, wp=3, ctb=32,
                         sao=1, deblock=2, amp=1)
    if container == "h265":
        path = _write(tmp_path, stream)
    elif container == "avi":
        path = str(tmp_path / "s.avi")
        hw.to_avi(stream, path, b"HEVC")
    else:
        path = str(tmp_path / "s.mp4")
        hw.to_mp4(stream, path, container.encode())
        d = mp4.Demuxer(path)
        cts = d.track.cts
        d.close()
        delta = mp4.rate(30.0)[1]  # to_mp4's sample duration
        assert mp4.guess_video_delay([i * delta + c for i, c in enumerate(cts)]) == 2
    stats = assert_reads_as_cv2(path)
    assert stats["b_slices"] > 0 and stats["reordered_outputs"] > 0
    got, _, _ = _port(path)
    ref, _, _ = _port(_write(tmp_path, stream, "ref.h265"))
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        for c in range(3):
            np.testing.assert_array_equal(g[c], r[c])


@pytest.mark.parametrize("tag", ["HEVC", "H265", "X265", "HVC1", "HEV1"])
def test_avi_fourccs_read_as_hevc(tmp_path, tag):
    path = str(tmp_path / "s.avi")
    hw.to_avi(hw.exercise(frames=2, seed=3), path, tag.encode())
    with open_reader(path) as r:
        assert r.codec == "hevc" and len(list(r.i420_frames())) == 2


@pytest.mark.parametrize("window", ["right_bottom", "top"])
def test_conformance_window_crops_as_cv2(tmp_path, window):
    """A coded size in whole coding blocks and the window the SPS crops to
    (as a 1080p camera codes 1088 rows): cv2's frames at cv2's size."""
    stream = hw.exercise(frames=3, seed=2, width=60, height=44, conf_win=window == "top")
    stats = assert_reads_as_cv2(_write(tmp_path, stream))
    with open_reader(_write(tmp_path, stream, "t.h265")) as r:
        assert (r.width, r.height) == (60, 44)
    assert stats["cropped_pictures"] == 3


def test_left_crop_is_refused(tmp_path):
    """FFmpeg keeps its planes aligned and crops a left edge of fewer than
    64 samples less than the SPS says, and cv2 rescales that frame: the
    port refuses it by name."""
    stream = hw.exercise(frames=2, seed=3, width=60, height=44, conf_win=2)
    with pytest.raises(ValueError, match="conformance window with a left offset"):
        _port(_write(tmp_path, stream))


def test_stream_cut_at_a_cra_picture_skips_its_rasl_pictures(tmp_path):
    """A clip that starts at a CRA picture: its RASL pictures refer to
    pictures before it, and FFmpeg skips them; the missing references of
    the CRA picture's own set are made gray."""
    stream = hw.exercise(frames=12, seed=1, cra=1, idr_every=4, reorder=1, refs=2)
    aus = list(hevc.access_units(hevc.nal_units(stream)))
    params = [n for n in aus[0] if hevc.nal_type(n) in (32, 33, 34)]
    k = next(i for i, au in enumerate(aus) if any(hevc.nal_type(n) == 21 for n in au))
    cut = b"".join(hevc.annexb(au) for au in [params + aus[k]] + aus[k + 1:])
    stats = assert_reads_as_cv2(_write(tmp_path, cut))
    assert stats["rasl_skipped"] == 1 and stats["missing_refs"] > 0


@pytest.mark.parametrize("start", [1, 2])
def test_stream_without_an_irap_start_reads_as_cv2(tmp_path, start):
    """A clip cut from a longer recording at a trailing picture: a picture
    that refers to a missing reference is not decoded (FFmpeg's "Error
    constructing the frame RPS"), nor the pictures that refer to it, until
    the next IRAP picture."""
    stream = hw.exercise(frames=12, seed=start, cra=1, idr_every=6, refs=1)
    aus = list(hevc.access_units(hevc.nal_units(stream)))
    params = [n for n in aus[0] if hevc.nal_type(n) in (32, 33, 34)]
    cut = b"".join(hevc.annexb(au) for au in
                   [params + [n for n in aus[start] if hevc.nal_type(n) < 32]] + aus[start + 1:])
    stats = assert_reads_as_cv2(_write(tmp_path, cut))
    assert stats["dropped_pictures"] == 6 - start


def test_b_stream_cut_at_a_cra_picture_skips_its_rasl_pictures(tmp_path):
    """An open-GOP B stream cut at its CRA picture: the hierarchical B
    pictures that lead it refer to pictures before the cut and are
    skipped, as FFmpeg skips them."""
    stream = hw.exercise(frames=13, seed=2, bframes=3, pyramid=1, cra=1, idr_every=8, tmvp=1)
    aus = list(hevc.access_units(hevc.nal_units(stream)))
    params = [n for n in aus[0] if hevc.nal_type(n) in (32, 33, 34)]
    k = next(i for i, au in enumerate(aus) if any(hevc.nal_type(n) == 21 for n in au))
    cut = b"".join(hevc.annexb(au) for au in [params + aus[k]] + aus[k + 1:])
    stats = assert_reads_as_cv2(_write(tmp_path, cut))
    assert stats["rasl_skipped"] == 3 and stats["b_slices"] > 0


def test_stream_starting_with_a_trailing_i_picture_reads_as_cv2(tmp_path):
    """A trailing I picture without references first: decoded and output."""
    stream = hw.exercise(frames=8, seed=4, trail_start=1, idr_every=5, cra=1, refs=2)
    stats = assert_reads_as_cv2(_write(tmp_path, stream))
    assert stats["pictures"] == 8 and stats["dropped_pictures"] == 0


@pytest.mark.parametrize("tool", list(hw.REFUSED))
def test_refused_tools_raise_by_name(tool):
    d = hevc.Decoder()
    with pytest.raises(ValueError, match=re.escape(tool.strip())):
        d.decode(hw.refused(hw.REFUSED[tool]))


def test_context_and_angle_tables_are_libavcodecs():
    """The CABAC context initialisation values of the three init types and
    the intra angles are cv2's libavcodec's, byte for byte: each run of
    ``kCtxInit`` lies in order inside one of libavcodec's rows."""
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    found = glob.glob(os.path.join(libs, "libavcodec-*.so*"))
    if not found:
        pytest.skip("cv2 without its bundled libavcodec")
    blob = open(found[0], "rb").read()
    src = open(hevc.SRC).read()
    body = src[src.index("kCtxInit[3][C_COUNT] = {"):]
    body = body[:body.index("};\n")]
    rows = [[int(x) for x in re.findall(r"\b\d+\b", part.split("},")[0])] for part in body.split("    {")[1:]]
    assert [len(r) for r in rows] == [154] * 3
    runs = [(0, 1), (1, 1), (2, 3), (5, 1), (6, 3), (38, 2), (9, 1), (10, 4), (14, 1), (15, 1),
            (17, 1), (18, 1), (19, 5), (24, 2), (36, 1), (37, 1), (26, 1), (16, 1), (27, 3),
            (30, 2), (32, 4), (40, 2), (42, 18), (60, 18), (78, 4), (82, 42), (124, 24), (148, 6)]
    unused_in_i = {6, 38, 9, 17, 18, 19, 24, 36, 37, 26, 16}
    for t, row in enumerate(rows):
        at = blob.find(bytes(row[42:78]))
        assert at > 0, f"init type {t}: last_sig_coeff prefixes not in libavcodec"
        ff = blob[at - 53:at - 53 + 199]  # FFmpeg's row: 53 contexts before them
        pos = 0
        for start, n in runs:
            if t == 0 and start in unused_in_i:
                continue
            want = bytes(row[start:start + (1 if t == 0 and start == 10 else n)])
            p = ff.find(want, pos if start != 38 else 0)
            assert p >= 0, f"init type {t}: contexts {start}..{start + n - 1}"
            if start != 38:
                pos = p + len(want)
    angle = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32, -26, -21, -17,
             -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32]
    inv = [-4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482, -630, -910, -1638,
           -4096]
    assert blob.find(struct.pack("<33i", *angle)) > 0 and blob.find(struct.pack("<15i", *inv)) > 0


FUZZ_SCRIPT = textwrap.dedent(
    """
    import random, sys
    sys.path.insert(0, "tests/data/video")
    import hevc_writer as hw
    from adas_tpu_torch.render import hevc

    rng = random.Random(int(sys.argv[1]))
    b_tools = sys.argv[3] == "b"
    decoded = refused = 0
    for it in range(int(sys.argv[2])):
        extra = {}
        if b_tools:
            extra = dict(bframes=rng.choice([0, 1, 3]), pyramid=rng.randint(0, 1), gpb=rng.choice([0, 100]),
                         wp=rng.randint(0, 3), mvd_l1_zero=rng.choice([0, 50]), col=rng.randint(0, 2),
                         list_mod=rng.randint(0, 1), frames=rng.randint(2, 6))
        stream = bytearray(hw.exercise(**{**dict(
            seed=rng.randint(0, 10 ** 6), frames=rng.randint(1, 4), ctb=rng.choice([16, 32, 64]),
            amp=1, pcm=10, tskip=1, sign_hiding=1, qp_delta=rng.randint(0, 2), scaling=rng.randint(0, 3),
            cip=rng.randint(0, 1), tmvp=1, refs=rng.randint(1, 3), deblock=2, sao=1,
            wpp=rng.randint(0, 1), slices=rng.randint(1, 3), across=2, reorder=rng.randint(0, 1),
            width=rng.choice([16, 48, 64]), height=rng.choice([16, 32, 48])), **extra}))
        kind = it % 3
        if kind == 0:
            stream = stream[:rng.randint(0, len(stream))]
        else:
            for _ in range(rng.randint(1, 8)):
                i = rng.randrange(len(stream))
                stream[i] = rng.randint(0, 255) if kind == 1 else stream[i] ^ 1 << rng.randint(0, 7)
        d = hevc.Decoder(None)
        try:
            for au in hevc.access_units(hevc.nal_units(bytes(stream))):
                d.decode(hevc.annexb(au))
            d.flush()
            decoded += 1
        except ValueError:
            refused += 1
        d.close()
    print(decoded, refused)
    """
)


def _fuzz(seed, tools):
    proc = subprocess.run([sys.executable, "-c", FUZZ_SCRIPT, str(seed), "120", tools], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoded, refused = map(int, proc.stdout.split())
    assert decoded + refused == 120 and refused > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_truncated_and_mutated_streams_decode_or_raise(seed):
    """Truncated streams and streams with bytes replaced or bits flipped
    decode or raise ``ValueError``; the process never crashes."""
    _fuzz(seed, "ip")


@pytest.mark.parametrize("seed", [3, 4])
def test_truncated_and_mutated_b_streams_decode_or_raise(seed):
    """The same over streams of B slices (hierarchical, low-delay) with
    weighted prediction, both co-located lists and list modification."""
    _fuzz(seed, "b")


# ------------------------------------------------------------------ the 720p clip

with open(os.path.join(DATA, "hevc", "sha256.json")) as _f:
    DIGESTS = json.load(_f)


def test_720p_content_clip_gives_cv2s_digests(tmp_path):
    """The 720p content clip of ``chip_smoke.py`` (a PCM IDR picture of
    ``tests/data/images/frame_720p.png``, then P pictures of a
    quarter-sample pan by merge and AMVP, WPP on) as an ``hvc1`` MP4: cv2's
    frame count and Y digests, committed by ``make_fixtures.py hevc``."""
    path = str(tmp_path / "c.mp4")
    hw.to_mp4(hw.content_720p(), path)
    want = DIGESTS["content_720p"]
    with open_reader(path) as r:
        ys = [hashlib.sha256(np.ascontiguousarray(f[:720]).tobytes()).hexdigest()
              for f in r.i420_frames()]
        stats = r.stats()
    assert ys == want["y_sha256"] and len(ys) == want["frames"]
    assert stats["pcm_cus"] > 0 and stats["merge_pus"] > 0 and stats["amvp_pus"] > 0
    assert stats["wpp_rows"] > 0 and stats["skip_cus"] > 0


@pytest.fixture(scope="module")
def content_720p_b():
    return hw.content_720p_b()


@pytest.mark.parametrize("container", ["hvc1", "avi", "h265"])
def test_720p_b_clip_gives_cv2s_digests(tmp_path, content_720p_b, container):
    """The 720p B clip of ``chip_smoke.py`` (a PCM IDR picture, then GOPs of
    a P anchor and three hierarchical B pictures, b-pyramid with a reorder
    depth of 2, over the pan of the content clip and a luma fade carried
    by explicit weights in P and B slices) as an ``hvc1`` MP4 with
    ``ctts``/``elst``, an AVI and Annex B: cv2's frame count and Y digests,
    committed by ``make_fixtures.py hevc``."""
    want = DIGESTS["content_720p_b"]
    if container == "hvc1":
        path = str(tmp_path / "c.mp4")
        hw.to_mp4(content_720p_b, path)
    elif container == "avi":
        path = str(tmp_path / "c.avi")
        hw.to_avi(content_720p_b, path, b"HEVC", 1280, 720)
    else:
        path = _write(tmp_path, content_720p_b, "c.h265")
    with open_reader(path) as r:
        ys = [hashlib.sha256(np.ascontiguousarray(f[:720]).tobytes()).hexdigest()
              for f in r.i420_frames()]
        stats = r.stats()
    assert ys == want["y_sha256"] and len(ys) == want["frames"]
    assert stats["b_slices"] > 0 and stats["bi_pus"] > 0 and stats["weighted_pus"] > 0
    assert stats["reordered_outputs"] > 0 and stats["weighted_slices"] == want["frames"] - 1
