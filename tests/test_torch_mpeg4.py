"""The port's MPEG-4 Part 2 (``mp4v``) decoder and encoder
(``native/mpeg4.cpp`` through ``render/mpeg4.py`` and
``render/video.MP4Reader`` / ``MP4Writer``) against cv2's, on the CPU.

* Decoder: every frame of every fixture in ``tests/data/video`` (written
  by cv2 from seeded frames, and one by the port, since cv2's writer never
  turns AC prediction on) gives cv2's Y planes to the bit, both live
  (``cv2.VideoCapture`` with ``CAP_PROP_CONVERT_RGB`` 0 returns the
  decoded luma plane) and as committed (``.npy``, ``sha256.json``).  Chroma
  cannot be read raw from cv2 (its BGR goes through swscale), so it is
  held by drift: on every P-VOP the 99th percentile of the BGR gap to
  cv2's decode stays within 1 level of the gap on the I-VOP that starts
  its GOP (measured: 2 levels on every frame of cv2's files, 2-3 on the
  port's).  The decoder's counters show the fixtures use every tool it
  implements.
* Encoder: cv2 opens the port's files and reads every frame at the
  written size and 30 fps; its Y planes equal the port's decode, which
  equals the writer's reconstruction to the bit; Y PSNR >= 38 dB against
  the source on smooth content.
* The tools the decoder does not implement (interlace, data partitioning,
  sprites / GMC, OBMC, the short video header, ...), other codecs, corrupt
  and truncated data, and oversized pictures raise ``ValueError``; so do
  seeded mutations of the fixtures, or they decode.  The Advanced Simple
  tools (B-VOPs, 4MV, quarter-sample, MPEG quantisation, video packets)
  are held to cv2 in ``test_torch_mpeg4_asp.py``.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from adas_tpu_torch.native.draw import i420_to_bgr  # noqa: E402
from adas_tpu_torch.ops.preprocess import bgr_to_i420  # noqa: E402
from adas_tpu_torch.render import mp4, mpeg4  # noqa: E402
from adas_tpu_torch.render.video import MP4Reader, MP4Writer  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
FIXTURES = sorted(glob.glob(os.path.join(DATA, "*.mp4")))
with open(os.path.join(DATA, "sha256.json")) as _f:
    DIGESTS = json.load(_f)


def _decode(path):
    """(I420 planes per frame, VOP types, decoder stats)."""
    planes, types = [], []
    with MP4Reader(path) as r:
        while (p := r.read_i420()) is not None:
            planes.append(p)
            types.append(r._decoder.last_type)
        return planes, types, r.stats()


def _cv2_frames(path, convert_rgb):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 1 if convert_rgb else 0)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out, fps


def smooth(n, h, w, speed=3, seed=0):
    """Seeded smooth colour frames panning ``speed`` px a frame."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        xs = x + speed * t
        b = 128 + 60 * np.sin(xs / 13.0) * np.cos(y / 17.0) + 40 * np.sin((xs + y) / 29.0)
        g = 128 + 70 * np.cos(xs / 23.0) + 30 * np.sin(y / 7.0)
        r = 128 + 80 * np.sin((xs - 2 * y) / 31.0)
        img = np.stack([b, g, r], -1) + rng.normal(0, 2, (h, w, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_decoder_gives_cv2s_luma_to_the_bit(path):
    name = os.path.basename(path)
    planes, types, _ = _decode(path)
    want = DIGESTS[name]
    h, w = want["height"], want["width"]
    assert len(planes) == want["frames"] and types[0] == "I"
    ys = [p[:h] for p in planes]
    live, fps = _cv2_frames(path, convert_rgb=False)
    assert fps == 30.0 and len(live) == len(ys)
    for i, (got, ref) in enumerate(zip(ys, live)):
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} frame {i}")
    assert [hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"]
    npy = path[:-4] + "_y.npy"
    if os.path.exists(npy):
        np.testing.assert_array_equal(np.stack(ys), np.load(npy))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_chroma_does_not_drift_from_cv2s(path):
    planes, types, _ = _decode(path)
    live, _ = _cv2_frames(path, convert_rgb=True)
    h, w = live[0].shape[:2]
    gaps = [np.percentile(np.abs(i420_to_bgr(p, h, w).astype(int) - ref), 99)
            for p, ref in zip(planes, live)]
    start = None
    for i, (t, gap) in enumerate(zip(types, gaps)):
        if t == "I":
            start = gap
        assert gap <= start + 1, (os.path.basename(path), i, gaps)
    if os.path.basename(path) == "cv2_fast_100x58.mp4":  # the committed BGR decode
        committed = np.load(path[:-4] + "_bgr.npy")
        np.testing.assert_array_equal(committed, np.stack(live))


def test_fixtures_exercise_every_tool():
    totals = {}
    for path in FIXTURES:
        stats = _decode(path)[2]
        for k, v in stats.items():
            totals[k] = max(totals.get(k, 0), v) if k == "max_fcode" else totals.get(k, 0) + v
        if os.path.basename(path).startswith("cv2_"):
            assert not stats["ac_pred_on"]  # cv2's writer never predicts AC
    for k in ("i_vops", "p_vops", "p_rounding_0", "p_rounding_1", "intra_mbs_in_i",
              "intra_mbs_in_p", "inter_mbs", "not_coded_mbs", "ac_pred_on", "ac_pred_off",
              "escape_1", "escape_2", "escape_3", "mv_outside"):
        assert totals[k] > 0, (k, totals)
    assert totals["max_fcode"] >= 2
    cv2_only = {}
    for path in FIXTURES:
        if os.path.basename(path).startswith("cv2_"):
            for k, v in _decode(path)[2].items():
                cv2_only[k] = cv2_only.get(k, 0) + v
    for k in ("intra_mbs_in_p", "not_coded_mbs", "escape_1", "escape_2", "escape_3",
              "p_rounding_0", "p_rounding_1"):
        assert cv2_only[k] > 0, (k, cv2_only)
    sizes = [(v["width"], v["height"]) for v in DIGESTS.values()]
    assert any(w % 16 or h % 16 for w, h in sizes)


@pytest.mark.parametrize("hw,speed", [((144, 176), 3), ((58, 100), 21)], ids=["smooth", "fast"])
def test_cv2_reads_what_the_encoder_writes(tmp_path, hw, speed):
    h, w = hw
    frames = smooth(26, h, w, speed, seed=5)
    path = str(tmp_path / "port.mp4")
    with MP4Writer(path, w, h, 30.0) as vw:
        recon = [vw.write(f) for f in frames]
    planes, types, stats = _decode(path)
    assert types == ["I" if i % 12 == 0 else "P" for i in range(len(frames))]
    assert stats["max_fcode"] == mpeg4.FCODE
    for got, want in zip(planes, recon):
        np.testing.assert_array_equal(got, want)
    live, fps = _cv2_frames(path, convert_rgb=False)
    assert fps == 30.0 and len(live) == len(frames)
    for i, (ref, p) in enumerate(zip(live, planes)):
        assert ref.shape == (h, w)
        np.testing.assert_array_equal(ref, p[:h], err_msg=f"frame {i}")
    worst = min(psnr(p[:h], bgr_to_i420(f)[:h]) for p, f in zip(planes, frames))
    assert worst >= 38.0, worst


def test_encoder_checks_its_input(tmp_path):
    with pytest.raises(ValueError, match="even"):
        MP4Writer(str(tmp_path / "odd.mp4"), 63, 64)
    with pytest.raises(ValueError, match="time resolution"):
        mpeg4.Encoder(64, 64, resolution=70000)
    with pytest.raises(ValueError, match="larger than"):
        mpeg4.Encoder(8192, 8192)
    enc = mpeg4.Encoder(64, 48)
    with pytest.raises(ValueError, match="bytes of I420"):
        enc.encode(np.zeros((10, 10), np.uint8))


# ---- crafted streams: the refused tools


class Bits:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def start(self, code):
        while len(self.bits) % 8:
            self.bits.append(1 if self.bits and len(self.bits) % 8 else 0)
        return self.put(1, 24).put(code, 8)

    def stuffing(self):
        self.put(0, 1)
        while len(self.bits) % 8:
            self.bits.append(1)
        return self

    def bytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def vol(width=32, height=16, verid=1, interlaced=0, obmc_disable=1, sprite=0, not_8_bit=0,
        quant_type=0, quarter=0, complexity_disable=1, resync_disable=1, partitioned=0,
        shape=0, scalability=0):
    b = Bits().put(1, 24).put(0x20, 8).put(0, 1).put(1, 8)
    if verid != 1:
        b.put(1, 1).put(verid, 4).put(1, 3)
    else:
        b.put(0, 1)
    b.put(1, 4).put(1, 1).put(1, 2).put(1, 1).put(0, 1)  # square, 4:2:0, low delay
    b.put(shape, 2).put(1, 1).put(30, 16).put(1, 1).put(0, 1)
    b.put(1, 1).put(width, 13).put(1, 1).put(height, 13).put(1, 1)
    b.put(interlaced, 1).put(obmc_disable, 1).put(sprite, 1 if verid == 1 else 2)
    b.put(not_8_bit, 1).put(quant_type, 1)
    if verid != 1:
        b.put(quarter, 1)
    b.put(complexity_disable, 1).put(resync_disable, 1).put(partitioned, 1)
    if verid != 1:
        b.put(0, 1).put(0, 1)
    b.put(scalability, 1)
    return b.stuffing().bytes()


def vop_header(kind, q=4, fcode=1):
    b = Bits().put(1, 24).put(0xB6, 8).put(kind, 2).put(0, 1).put(1, 1).put(0, 5).put(1, 1)
    b.put(1, 1)  # vop_coded
    if kind == 1:
        b.put(0, 1)
    b.put(0, 3).put(q, 5)
    if kind:
        b.put(fcode, 3)
    return b


def empty_intra_mb(b):
    """An I-VOP macroblock with no coefficients and DC differentials of 0."""
    b.put(1, 1).put(0, 1).put(0b0011, 4)  # mcbpc intra cbpc 0, ac_pred 0, cbpy 0
    for _ in range(4):
        b.put(0b011, 3)  # luma dct_dc_size 0
    return b.put(0b11, 2).put(0b11, 2)  # chroma dct_dc_size 0


def i_vop(width=32, height=16):
    b = vop_header(0)
    for _ in range(((width + 15) // 16) * ((height + 15) // 16)):
        empty_intra_mb(b)
    return b.stuffing().bytes()


def _tcoef_tables():
    """The library's two TCOEF tables as (codes, runs, levels, last_start),
    read from its source: the tests drive every code through cv2."""
    import re

    src = open(mpeg4._SRC).read()
    out = {}
    for name in ("kIntraTcoef", "kInterTcoef"):
        block = src[src.index(f"const RunLevel {name} = {{"):]
        block = block[:block.index("};")]
        groups = re.findall(r"\{([^{}]*)\}", block)
        codes = [tuple(int(x, 0) for x in g.split(",")) for g in groups[:103]]
        runs, levels = ([int(x) for x in g.split(",") if x.strip()] for g in groups[103:105])
        out[name] = (codes, runs, levels, int(block.rstrip().rsplit(",", 1)[1]))
    return out["kIntraTcoef"], out["kInterTcoef"]


def _event(b, table, k, sign):
    code, n = table[0][k]
    b.put(code, n).put(sign, 1)


def _events(b, table, events):
    """(kind, k, sign) per event: kind 0 a plain code, 1-2 the first and
    second escapes (code k inside), 3 the third escape (k = (last, run,
    level)); a block ends with a last event."""
    esc = table[0][102]
    for kind, k, sign in events:
        if kind == 0:
            _event(b, table, k, sign)
        elif kind in (1, 2):
            b.put(*esc).put(0 if kind == 1 else 2, kind)
            _event(b, table, k, sign)
        else:
            last, run, level = k
            b.put(*esc).put(3, 2).put(last, 1).put(run, 6).put(1, 1).put(level & 0xFFF, 12)
            b.put(1, 1)


def _coded_frames(intra_events, inter_events):
    """VOPs of 32x16: an I-VOP per intra event list (block 0 of the first
    macroblock coded), then a P-VOP per inter event list (block 0 of an
    inter macroblock with a zero vector, the other macroblock not coded)."""
    frames = []
    for events in intra_events:
        b = vop_header(0)
        b.put(1, 1).put(0, 1).put(0b00010, 5)  # mcbpc intra, ac_pred 0, cbpy 8: block 0
        b.put(0b011, 3)  # block 0: luma DC size 0, then its coefficients
        _events(b, INTRA, events)
        for _ in range(3):
            b.put(0b011, 3)
        b.put(0b11, 2).put(0b11, 2)
        frames.append((empty_intra_mb(b).stuffing().bytes(), True))
    for events in inter_events:
        b = vop_header(1)
        # coded, mcbpc inter cbpc 0, cbpy 15 - 8 = 7 (block 0), zero vector differences
        b.put(0, 1).put(1, 1).put(0b1011, 4).put(1, 1).put(1, 1)
        _events(b, INTER, events)
        frames.append((b.put(1, 1).stuffing().bytes(), False))
    return frames


INTRA, INTER = _tcoef_tables()


def test_tcoef_tables_are_complete_prefix_codes():
    """Both tables hold the same 103 codewords (Tables B-16 and B-17 map
    one codebook to different events), prefix-free; every (last, run) of
    the LMAX tables has levels 1..LMAX and no gaps."""
    assert sorted(INTRA[0]) == sorted(INTER[0]) and len(INTRA[0]) == 103
    words = sorted(format(c, f"0{n}b") for c, n in INTRA[0])
    assert all(not b.startswith(a) for a, b in zip(words, words[1:]))
    for codes, runs, levels, last_start in (INTRA, INTER):
        seen = {}
        for k in range(102):
            seen.setdefault((k >= last_start, runs[k]), []).append(levels[k])
        assert all(v == list(range(1, len(v) + 1)) for v in seen.values())
    inter_lmax = {(0, r): len(v) for (last, r), v in
                  ((key, [1] * n) for key, n in
                   (((lst, r), sum(1 for k in range(102) if (k >= INTER[3]) == lst
                                   and INTER[1][k] == r)) for lst in (0, 1)
                    for r in range(41)))
                  if last == 0 and v}
    # the spec's LMAX of inter codes, last 0: 12, 6, 4, 3 x 4, 2 x 4, 1 x 16
    assert [inter_lmax[(0, r)] for r in range(27)] == [12, 6, 4] + [3] * 4 + [2] * 4 + [1] * 16


def test_every_tcoef_code_and_escape_decodes_as_cv2s(tmp_path):
    """One frame per code of each table, and frames of each escape, muxed
    and read by cv2: every frame's Y planes equal the port's."""
    end_i, end_p = (0, INTRA[3], 0), (0, INTER[3], 0)  # (last 1, run 0, level 1)
    intra = [[(0, k, k % 2)] + ([] if k >= INTRA[3] else [end_i]) for k in range(102)]
    inter = [[(0, k, k % 2)] + ([] if k >= INTER[3] else [end_p]) for k in range(102)]
    # escapes: a level past LMAX (1), a run past RMAX (2), fixed length (3)
    intra += [[(1, 2, 0), (1, 40, 1), end_i], [(2, 50, 1), (2, 70, 0)],
              [(3, (0, 3, -300), 0), (3, (1, 5, 2047), 0)]]
    inter += [[(1, 0, 1), (1, 45, 0), end_p], [(2, 41, 0), (2, 60, 1)],
              [(3, (0, 0, 200), 0), (3, (1, 20, -255), 0)]]
    frames = _coded_frames(intra, inter)
    path = str(tmp_path / "codes.mp4")
    dsi = vol()
    mux = mp4.Muxer(path, 32, 16, dsi, 30, 1)
    for data, key in frames:
        mux.add(data, key)
    mux.close()
    planes, _, stats = _decode(path)
    assert len(planes) == len(frames)
    assert min(stats["escape_1"], stats["escape_2"], stats["escape_3"]) >= 4
    live, _ = _cv2_frames(path, convert_rgb=False)
    assert len(live) == len(frames)
    for i, (p, ref) in enumerate(zip(planes, live)):
        np.testing.assert_array_equal(p[:16], ref, err_msg=f"frame {i}")


def test_crafted_stream_decodes():
    """The crafted headers are valid: a gray I-VOP decodes (a low-delay VOL:
    the frame comes out at once)."""
    dec = mpeg4.Decoder(vol())
    [planes] = dec.decode(i_vop())
    assert dec.last_type == "I" and dec.flush() == []
    assert (planes == 128).all()  # DC levels predicted from 1024 / 8


@pytest.mark.parametrize("kwargs,name", [
    ({"interlaced": 1}, "interlaced"),
    ({"obmc_disable": 0}, "OBMC"),
    ({"sprite": 1}, "sprites"),
    ({"not_8_bit": 1}, "not_8_bit"),
    ({"quant_type": 1}, "MPEG quantisation"),
    ({"verid": 2, "quarter": 1}, "quarter-pel"),
    ({"complexity_disable": 0}, "complexity estimation"),
    ({"partitioned": 1}, "data partitioning"),
    ({"shape": 1}, "shape"),
    ({"scalability": 1}, "scalability"),
    ({"width": 8191, "height": 8191}, "larger than"),
    ({"width": 0}, "empty"),
])
def test_refused_vol_tools_raise_by_name(kwargs, name):
    """Tools the decoder lacks raise by name.  Quarter-sample and
    interlaced VOLs are decoded now (``test_torch_mpeg4_asp.py``): the
    decoder takes them (an I-VOP after a quarter-sample one decodes; an
    interlaced VOP carries two more header bits); an MPEG quantisation VOL
    here reads the next header bits as a loaded matrix, which the VOL cuts
    short."""
    if name == "quarter-pel":
        dec = mpeg4.Decoder(vol(**kwargs))
        [planes] = dec.decode(i_vop())
        assert (planes == 128).all()
        return
    if name == "interlaced":
        dec = mpeg4.Decoder(vol(**kwargs))
        assert (dec.width, dec.height) == (32, 16)
        return
    with pytest.raises(ValueError, match=name):
        mpeg4.Decoder(vol(**kwargs))


def test_refused_vop_tools_raise_by_name():
    """S-VOPs and the short video header raise by name.  B-VOPs, inter4v
    and video packets are decoded now: a B-VOP with no past reference is
    passed over as FFmpeg passes it, an inter4v macroblock decodes, and a
    video packet header is read (here one whose macroblock number is out
    of range, which raises)."""
    dec = mpeg4.Decoder(vol())
    with pytest.raises(ValueError, match="P-VOP without a reference"):
        dec.decode(vop_header(1).stuffing().bytes())
    dec.decode(i_vop())
    assert dec.decode(vop_header(2, fcode=1).put(1, 3).stuffing().bytes()) == []
    with pytest.raises(ValueError, match="S-VOPs"):
        dec.decode(vop_header(3).stuffing().bytes())
    # a P-VOP whose first macroblock is inter4v (mcbpc 010, cbpy 0, four
    # zero vector differences), the second not coded
    [planes] = dec.decode(vop_header(1).put(0, 1).put(0b010, 3).put(0b11, 2).put(0xFF, 8)
                          .put(1, 1).stuffing().bytes())
    assert (planes == 128).all() and dec.stats()["inter4v_mbs"] == 1
    with pytest.raises(ValueError, match="short video header"):
        dec.decode(b"\x00\x00\x80\x02" + bytes(20))
    with pytest.raises(ValueError, match="without a VOL"):
        mpeg4.Decoder(b"\x00\x00\x01\xb0\x01")
    # resync markers: a VOL that keeps them, and one after the first macroblock
    dec = mpeg4.Decoder(vol(resync_disable=0))
    b = empty_intra_mb(vop_header(0)).stuffing().put(1, 17)  # 16 zeros and a 1
    with pytest.raises(ValueError, match="video packet"):
        dec.decode(b.put(0, 8).bytes())


def test_truncated_and_corrupt_vops_raise():
    frames = smooth(3, 48, 64)
    enc = mpeg4.Encoder(64, 48)
    vops = [enc.encode(bgr_to_i420(f))[0] for f in frames]
    dec = mpeg4.Decoder(enc.header())
    dec.decode(vops[0])
    with pytest.raises(ValueError, match="truncated"):
        dec.decode(vops[1][:len(vops[1]) // 2])
    with pytest.raises(ValueError, match="MPEG-4"):
        dec.decode(vops[1][:8] + b"\x00" * 8 + vops[1][16:])


def test_mutated_fixtures_decode_or_raise_value_error():
    """300 fixture files with random bytes changed, cut, dropped or
    inserted: each reads to its end or raises ValueError."""
    rng = random.Random("mp4v")
    datas = [open(p, "rb").read() for p in FIXTURES]
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"mutated_{os.getpid()}.mp4")
    try:
        decoded = 0
        for _ in range(300):
            data = bytearray(rng.choice(datas))
            for _ in range(rng.randint(1, 8)):
                pos, r = rng.randrange(len(data)), rng.random()
                if r < 0.6:
                    data[pos] = rng.randrange(256)
                elif r < 0.8:
                    del data[pos:pos + rng.randint(1, 40)]
                else:
                    data[pos:pos] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 20)))
            if rng.random() < 0.2:
                data = data[:rng.randrange(8, len(data) + 1)]
            with open(tmp, "wb") as f:
                f.write(data)
            try:
                with MP4Reader(tmp) as r:
                    while (p := r.read_i420()) is not None:
                        assert p.dtype == np.uint8 and p.shape == (r.height * 3 // 2, r.width)
                decoded += 1
            except ValueError:
                continue
        assert 0 < decoded < 300
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def test_demuxer_reads_the_fixture_tracks():
    for path in FIXTURES:
        d = mp4.Demuxer(path)
        try:
            name = os.path.basename(path)
            assert (d.track.width, d.track.height) == (DIGESTS[name]["width"],
                                                       DIGESTS[name]["height"])
            assert d.track.fps == 30.0 and len(d) == DIGESTS[name]["frames"]
            assert d.track.dsi.startswith(b"\x00\x00\x01\xb0")
        finally:
            d.close()
