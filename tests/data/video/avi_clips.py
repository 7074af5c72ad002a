"""The 720p Motion JPEG clip of the AVI tests and ``chip_smoke.py``'s
``[video]``, built by the port's AVI muxer from the committed 720p JPEGs
(``tests/data/images/frame_720p_420.jpg`` and ``frame_720p_422.jpg``:
cv2's 4:2:0 and 4:2:2 encodes of one road frame), so that a host without
cv2 rebuilds it byte for byte and holds its decode to the digests of cv2's
decode in ``avi/sha256.json`` (``make_fixtures.py avi`` writes them).

``mjpeg_720p(path)`` writes ``FRAMES`` frames alternating the two JPEGs
as an ``MJPG`` AVI; ``damaged=True`` writes it as a recording cut short by
a power loss leaves it: no ``idx1``, the last chunk cut in half, and the
``RIFF`` and ``movi`` sizes never written (0).  cv2 reads ``FRAMES`` and
``FRAMES - 1`` frames of them.
"""
import os
import struct
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGES = os.path.join(os.path.dirname(HERE), "images")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from adas_tpu_torch.render import avi  # noqa: E402

JPEGS = ("frame_720p_420.jpg", "frame_720p_422.jpg")
FRAMES = 24


def jpegs():
    """The two committed 720p JPEGs' bytes, 4:2:0 first."""
    out = []
    for name in JPEGS:
        with open(os.path.join(IMAGES, name), "rb") as f:
            out.append(f.read())
    return out


def mjpeg_720p(path: str, damaged: bool = False) -> None:
    frames = jpegs()
    with avi.Muxer(path, 1280, 720, b"MJPG", 30.0) as mux:
        for i in range(FRAMES):
            mux.add(frames[i % 2], True)
    if not damaged:
        return
    with open(path, "rb") as f:
        data = bytearray(f.read())
    idx1 = data.rindex(b"idx1")
    last = data.rindex(b"00dc", 0, idx1)
    size = struct.unpack_from("<I", data, last + 4)[0]
    data = data[:last + 8 + size // 2]
    data[4:8] = bytes(4)
    movi = data.index(b"movi")
    data[movi - 4:movi] = bytes(4)
    with open(path, "wb") as f:
        f.write(bytes(data))
