"""The damaged 720p clips of the concealment checks (``chip_smoke.py``'s
``[video]`` concealment part, ``tests/test_torch_conceal.py``): the 720p
content clips of ``h264_writer`` (IBBBP, CABAC) and ``mpeg4_writer`` (ASP,
IBBP), each cut into slices or video packets of 9 macroblock rows and
muxed into an AVI, then damaged as a dash-cam's recording gets damaged:
20 bytes replaced in one slice or packet of a P and of a B picture, one
slice or packet of another P picture dropped, and the file cut in the
middle of its last chunk.  ``conceal_sha256.json`` holds the Y digests of
cv2's bundled libavcodec decoding the damaged clips on one thread
(``python tests/data/video/make_fixtures.py conceal``).  Needs no cv2.
"""
import os

import numpy as np

import h264_writer
import mpeg4_writer
from adas_tpu_torch.render import avi, h264

HERE = os.path.dirname(os.path.abspath(__file__))
#: the clips' damage: bytes replaced (count, from where in the slice or
#: packet's data, seed), the picture types hit
DAMAGE = {"bytes": 20, "at": 0.5, "seed": 22}
#: a slice or video packet every this many macroblock rows
ROWS = 9


def _replace(data: bytes, lo: int, hi: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    at = lo + int((hi - lo - DAMAGE["bytes"]) * DAMAGE["at"])
    out = bytearray(data)
    out[at:at + DAMAGE["bytes"]] = rng.integers(0, 256, DAMAGE["bytes"], dtype=np.uint8).tobytes()
    return bytes(out)


def _slice_type(nal: bytes) -> int:
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
    return ue() % 5  # 0 P, 1 B, 2 I


def _cut_last(path: str) -> None:
    d = avi.Demuxer(path)
    off, size = d.offsets[-1], d.sizes[-1]
    d.close()
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:off + size // 2])


def h264_720p(path: str) -> dict:
    """The 720p B clip with 5 slices a picture, damaged (see the module),
    as an AVI at ``path``; returns which access units were hit."""
    spec = h264_writer.CONTENT_720P_B
    stream = h264_writer.content(h264_writer._frame_720p(), n_p=spec["frames"] - 1,
                                 pan=spec["pan"], cabac=spec["cabac"], bframes=spec["bframes"],
                                 slice_rows=ROWS)
    aus = [list(au) for au in h264.access_units(h264.nal_units(stream))]
    types = [_slice_type(next(n for n in au if n[0] & 0x1F in (1, 5))) for au in aus]
    p_aus = [i for i, t in enumerate(types) if t == 0]
    b_aus = [i for i, t in enumerate(types) if t == 1]
    hit = {"p": p_aus[1], "b": b_aus[len(b_aus) // 2], "dropped": p_aus[3]}
    for key, seed in (("p", DAMAGE["seed"]), ("b", DAMAGE["seed"] + 1)):
        au = aus[hit[key]]
        sl = [j for j, n in enumerate(au) if n[0] & 0x1F in (1, 5)]
        j = sl[len(sl) // 2]
        au[j] = _replace(au[j], 8, len(au[j]), seed)
    au = aus[hit["dropped"]]
    del au[[j for j, n in enumerate(au) if n[0] & 0x1F in (1, 5)][2]]
    with avi.Muxer(path, 1280, 720, b"H264") as m:
        for au in aus:
            m.add(h264.annexb(au), any(n[0] & 0x1F == 5 for n in au))
    _cut_last(path)
    return hit


def mpeg4_720p(path: str) -> dict:
    """The 720p ASP clip with a video packet every 9 macroblock rows,
    damaged (see the module), as an AVI at ``path``; returns which samples
    were hit."""
    spec = mpeg4_writer.CONTENT_720P
    frames = mpeg4_writer.pan_frames(mpeg4_writer.frame_720p(), spec["frames"], spec["pan"])
    st = mpeg4_writer.content(frames, spec["pan"], frames=spec["frames"], bframes=spec["bframes"],
                              packets=ROWS)
    samples = list(st.samples)
    p_vops = [i for i, t in enumerate(st.types) if t == 1]
    b_vops = [i for i, t in enumerate(st.types) if t == 2]
    hit = {"p": p_vops[1], "b": b_vops[len(b_vops) // 2], "dropped": p_vops[2]}

    def packets(vop: bytes):
        start = vop.rfind(b"\x00\x00\x01\xb6") + 4
        return [i for i in range(start + 4, len(vop) - 3)
                if vop[i] == 0 and vop[i + 1] == 0 and vop[i + 2] > 3 and vop[i - 1] != 0]

    for key, seed in (("p", DAMAGE["seed"]), ("b", DAMAGE["seed"] + 1)):
        vop = samples[hit[key]]
        marks = packets(vop)
        k = len(marks) // 2
        samples[hit[key]] = _replace(vop, marks[k] + 8, marks[k + 1], seed)
    vop = samples[hit["dropped"]]
    marks = packets(vop)
    samples[hit["dropped"]] = vop[:marks[1]] + vop[marks[2]:]
    with avi.Muxer(path, 1280, 720, b"XVID") as m:
        for s, key in zip(samples, st.keys):
            m.add(s, key)
    _cut_last(path)
    return hit


CLIPS = {"conceal_720p_h264.avi": h264_720p, "conceal_720p_mpeg4.avi": mpeg4_720p}
