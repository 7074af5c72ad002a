"""The MP4 (ISO BMFF) container of the demo's video, without cv2 or
FFmpeg: a demuxer for the first video track and a muxer of one ``mp4v``
track.

``Demuxer(path)`` walks the box tree, with ``moov`` before or after
``mdat``, and takes the first track whose handler is ``vide`` (an audio or
other track is ignored).  From it: the sample entry, either ``mp4v`` with
its ``esds`` DecoderSpecificInfo (the MPEG-4 Visual VOS/VO/VOL headers,
objectTypeIndication 0x20), H.264's ``avc1`` / ``avc3`` with its
``avcC`` record (``avc3`` may carry its parameter sets in band), H.265's
``hvc1`` / ``hev1`` with its ``hvcC`` record (``codec`` ``"hevc"``;
``hev1`` carries its parameter sets in band), or Motion
JPEG: ``jpeg`` and ``mjpa`` entries, and ``mp4v`` entries whose esds
names JPEG (0x6C, as cv2 writes ``MJPG`` into an ``.mp4``); the
samples' offsets and sizes from ``stsz``, ``stsc`` and ``stco``/``co64``,
the rate from ``mdhd``'s timescale over ``stts``, and for streams that
reorder (H.264 B pictures) the composition offsets of ``ctts`` (versions
0 and 1) and the edit list of ``edts``/``elst``.  ``Track.codec`` says
which (``"mjpeg"`` for Motion JPEG); ``Track.video_delay`` is the reorder depth FFmpeg's mov demuxer
reads from ``ctts`` (``mov_guess_video_delay``).  ``Track.rotation`` is the
clockwise turn, 0, 90, 180 or 270 degrees, that cv2's FFmpeg backend gives
the frames for the track's display matrix (``tkhd``'s after ``mvhd``'s,
``display_rotation``).  An edit list that cuts
frames raises, as does one that is not a single edit (after an empty
one).  Another sample entry (``av01``, ``mjpb``, ...) or object
type, and fragmented MP4 (``moof``), raise a ``ValueError`` that names the
codec or the feature; so does a box that runs past its parent or a sample
past the file.

``Muxer(path, width, height, dsi, timescale, delta)`` writes ``ftyp``,
then ``mdat`` as the samples come, then on ``close`` the ``moov`` (``mvhd``,
``tkhd``, ``mdhd``, ``hdlr vide``, ``vmhd``, ``dref``, ``stsd`` with
``mp4v`` + ``esds``, ``stts``, ``stss`` of the key samples, ``stsc``,
``stsz``, and ``stco``, or ``co64`` when an offset passes 4 GiB): the
layout ``cv2.VideoWriter`` writes for an ``.mp4`` path.  ``build_moov``
writes ``ctts`` and an ``elst`` that starts at the first frame's
composition time when given composition offsets, as FFmpeg's muxer does
for B pictures.
"""
from __future__ import annotations

import math
import struct
from fractions import Fraction
from typing import BinaryIO, List, Optional, Sequence, Tuple

#: the H.264 sample entries the demuxer reads (their ``avcC`` record)
AVC_ENTRIES = {b"avc1": "H.264 (avc1)", b"avc3": "H.264 (avc3)"}
#: the H.265 sample entries the demuxer reads (their ``hvcC`` record)
HEVC_ENTRIES = {b"hvc1": "H.265 (hvc1)", b"hev1": "H.265 (hev1)"}
#: the Motion JPEG sample entries the demuxer reads
MJPEG_ENTRIES = (b"jpeg", b"mjpa")
#: sample entries the demuxer names when it refuses them
CODEC_NAMES = {
    b"av01": "AV1 (av01)", b"vp08": "VP8 (vp08)",
    b"vp09": "VP9 (vp09)", b"mjpb": "MJPEG-B (mjpb)",
    b"s263": "H.263 (s263)", b"encv": "encrypted video (encv)",
}
#: objectTypeIndication of an esds that the demuxer names when it refuses it
OBJECT_TYPES = {0x6A: "MPEG-1 video", 0x60: "MPEG-2 video", 0x61: "MPEG-2 video",
                0x62: "MPEG-2 video", 0x63: "MPEG-2 video", 0x64: "MPEG-2 video",
                0x65: "MPEG-2 video", 0x21: "H.264"}
MPEG4_VISUAL = 0x20
#: the objectTypeIndication of JPEG (cv2's ``MJPG`` in an ``.mp4``)
JPEG_OBJECT = 0x6C


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from(">I", b, o)[0]


def iter_boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    """(type, payload start, payload end) of each box in ``data[start:end]``."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("truncated MP4 box header")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"corrupt MP4: box {kind!r} of {size} bytes runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


def _find(data: bytes, start: int, end: int, kind: bytes) -> Optional[Tuple[int, int]]:
    for k, s, e in iter_boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _need(data, start, end, kind) -> Tuple[int, int]:
    box = _find(data, start, end, kind)
    if box is None:
        raise ValueError(f"corrupt MP4: no {kind.decode('latin-1')} box")
    return box


def _descriptor(data: bytes, pos: int, end: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of the MPEG-4 descriptor at ``pos``."""
    if pos + 2 > end:
        raise ValueError("truncated esds descriptor")
    tag, pos, size = data[pos], pos + 1, 0
    for _ in range(4):
        if pos >= end:
            raise ValueError("truncated esds descriptor")
        b = data[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    if pos + size > end:
        raise ValueError("corrupt MP4: esds descriptor runs past its box")
    return tag, pos, pos + size


def parse_esds(data: bytes, start: int, end: int) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` box of
    MPEG-4 Visual, or of JPEG (whose DecoderSpecificInfo may be missing:
    then ``b""``)."""
    tag, s, e = _descriptor(data, start + 4, end)  # after version / flags
    if tag != 0x03:
        raise ValueError("corrupt MP4: esds without an ES_Descriptor")
    if s + 3 > e:
        raise ValueError("truncated ES_Descriptor")
    flags = data[s + 2]
    s += 3 + (2 if flags & 0x80 else 0)
    if flags & 0x40:
        if s >= e:
            raise ValueError("truncated ES_Descriptor")
        s += 1 + data[s]
    s += 2 if flags & 0x20 else 0
    tag, s, e = _descriptor(data, s, e)
    if tag != 0x04 or s + 13 > e:
        raise ValueError("corrupt MP4: esds without a DecoderConfigDescriptor")
    oti = data[s]
    if oti not in (MPEG4_VISUAL, JPEG_OBJECT):
        name = OBJECT_TYPES.get(oti, f"objectTypeIndication 0x{oti:02x}")
        raise ValueError(f"{name} in an MP4 is not supported (the port reads MPEG-4 Part 2 and "
                         f"JPEG in an mp4v entry)")
    pos = s + 13
    while pos < e:
        tag, ds, de = _descriptor(data, pos, e)
        if tag == 0x05:
            return oti, data[ds:de]
        pos = de
    if oti == JPEG_OBJECT:
        return oti, b""
    raise ValueError("corrupt MP4: esds without a DecoderSpecificInfo")


class Track:
    """The demuxed video track: size, rate, decoder config and samples.
    ``codec`` is ``"mp4v"`` (``dsi`` the MPEG-4 Visual headers) or
    ``"avc1"`` / ``"avc3"`` (``dsi`` the ``avcC`` record) or ``"mjpeg"``
    (Motion JPEG, ``dsi`` empty)."""

    def __init__(self, width, height, fps, dsi, offsets, sizes, timescale, duration,
                 codec="mp4v", cts=None, video_delay=0, rotation=0):
        self.width, self.height, self.fps, self.dsi = width, height, fps, dsi
        self.offsets, self.sizes = offsets, sizes
        self.timescale, self.duration = timescale, duration
        self.codec = codec
        #: each sample's composition offset (``ctts``), None without one
        self.cts = cts
        self.video_delay = video_delay
        #: the clockwise turn of the frames, in degrees (``display_rotation``)
        self.rotation = rotation


#: the identity display matrix (``tkhd``, ``mvhd``): 16.16, 16.16, 2.30
IDENTITY = (1 << 16, 0, 0, 0, 1 << 16, 0, 0, 0, 1 << 30)


def _int32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def display_matrix(track: Sequence[int], movie: Sequence[int]) -> Tuple[int, ...]:
    """``tkhd``'s matrix after ``mvhd``'s, in FFmpeg's fixed point
    (``mov_read_tkhd``: each product shifted by its row's 16, 16 or 30
    bits, the sums in 32 bits)."""
    out = []
    for i in range(3):
        for j in range(3):
            acc = 0
            for e, shift in enumerate((16, 16, 30)):
                acc = _int32(acc + ((track[3 * i + e] * movie[3 * e + j]) >> shift))
            out.append(acc)
    return tuple(out)


def display_rotation(matrix: Sequence[int]) -> int:
    """The clockwise turn cv2's FFmpeg backend gives frames of a display
    matrix: ``-cvRound(av_display_rotation_get(matrix))`` in [0, 360), and
    only 90, 180 and 270 turn (``cv::rotate``); another angle, a matrix
    without scale, and the identity leave the frames as decoded."""
    if tuple(matrix) == IDENTITY:
        return 0
    a, b, c, d = (v / 65536.0 for v in (matrix[0], matrix[1], matrix[3], matrix[4]))
    scale0, scale1 = math.hypot(a, c), math.hypot(b, d)
    if scale0 == 0.0 or scale1 == 0.0:
        return 0
    angle = -round(-(math.atan2(b / scale1, a / scale0) * 180 / math.pi))
    angle += 360 if angle < 0 else 0
    return angle if angle in (90, 180, 270) else 0


def _matrix(data: bytes, start: int, end: int, kind: bytes, v0: int, v1: int) -> Tuple[int, ...]:
    """The 3x3 matrix of an ``mvhd`` or ``tkhd`` box (at payload offset
    ``v0``, or ``v1`` in a version 1 box); FFmpeg's zeros without one."""
    found = _find(data, start, end, kind)
    if found is None:
        return (0,) * 9
    at = found[0] + (v1 if data[found[0]] == 1 else v0)
    if at + 36 > found[1]:
        raise ValueError(f"truncated {kind.decode()}")
    return struct.unpack_from(">9i", data, at)


#: the pts FFmpeg's mov demuxer keeps to guess the reorder delay
MAX_REORDER_DELAY = 16


def guess_video_delay(pts: Sequence[int]) -> int:
    """The reorder depth of samples' presentation times in decoding order,
    as FFmpeg's mov demuxer reads it (``mov_guess_video_delay``): the most
    of the 16 largest earlier times that exceed a sample's."""
    kept = [float("-inf")] * MAX_REORDER_DELAY
    delay = 0
    for p in pts:
        delay = max(delay, sum(k > p for k in kept))
        kept = sorted(kept + [p])[1:]
    return delay


def _ctts(data: bytes, s: int, e: int, count: int) -> Optional[List[int]]:
    found = _find(data, s, e, b"ctts")
    if found is None:
        return None
    version, n = data[found[0]], _u32(data, found[0] + 4)
    if found[0] + 8 + 8 * n > found[1]:
        raise ValueError("truncated ctts")
    cts: List[int] = []
    for i in range(n):
        run, off = struct.unpack_from(">I" + ("i" if version else "I"), data, found[0] + 8 + 8 * i)
        if len(cts) + run > count:  # before a corrupt run is expanded
            break
        cts += [off] * run
    else:
        if len(cts) == count:
            return cts
    total = sum(struct.unpack_from(">I", data, found[0] + 8 + 8 * i)[0] for i in range(n))
    raise ValueError(f"corrupt MP4: ctts gives {total} samples, stsz {count}")


def _check_edits(data: bytes, trak: Tuple[int, int], pts: List[int], timescale: int) -> None:
    """An edit list is read when it shows every frame: empty edits, then
    one edit from at most the first composition time.  (FFmpeg's muxer
    writes one from the first frame's.)"""
    edts = _find(data, *trak, b"edts")
    elst = None if edts is None else _find(data, *edts, b"elst")
    if elst is None:
        return
    version, n = data[elst[0]], _u32(data, elst[0] + 4)
    size = 20 if version == 1 else 12
    if elst[0] + 8 + size * n > elst[1]:
        raise ValueError("truncated elst")
    edits = [struct.unpack_from(">Qq" if version == 1 else ">Ii", data, elst[0] + 8 + size * i)
             for i in range(n)]
    media = [t for _, t in edits if t != -1]
    first = min(pts) if pts else 0
    if len(media) > 1 or (media and media[0] > first):
        raise ValueError("MP4 edit lists that cut or repeat frames are not supported (elst "
                         f"media times {media}, the first frame at {first} of {timescale})")


def _sample_table(data: bytes, s: int, e: int, file_size: int):
    stsz = _need(data, s, e, b"stsz")
    if stsz[1] - stsz[0] < 12:
        raise ValueError("truncated stsz")
    fixed, count = struct.unpack_from(">II", data, stsz[0] + 4)
    if fixed:
        if count * fixed > file_size:
            raise ValueError(f"corrupt MP4: {count} samples of {fixed} bytes in stsz, "
                             f"more than the file's {file_size}")
        sizes = [fixed] * count
    else:
        if stsz[0] + 12 + 4 * count > stsz[1]:
            raise ValueError("truncated stsz")
        sizes = list(struct.unpack_from(f">{count}I", data, stsz[0] + 12))
    chunks = _find(data, s, e, b"stco")
    wide = chunks is None
    chunks = chunks or _need(data, s, e, b"co64")
    n_chunks = _u32(data, chunks[0] + 4)
    if chunks[0] + 8 + n_chunks * (8 if wide else 4) > chunks[1]:
        raise ValueError("truncated chunk offset box")
    chunk_offsets = struct.unpack_from(f">{n_chunks}{'Q' if wide else 'I'}", data, chunks[0] + 8)
    stsc = _need(data, s, e, b"stsc")
    n_runs = _u32(data, stsc[0] + 4)
    if stsc[0] + 8 + 12 * n_runs > stsc[1]:
        raise ValueError("truncated stsc")
    runs = [struct.unpack_from(">III", data, stsc[0] + 8 + 12 * i) for i in range(n_runs)]
    offsets: List[int] = []
    for i, (first, per_chunk, desc) in enumerate(runs):
        if desc != 1:
            raise ValueError("MP4 tracks with several sample descriptions are not supported")
        last = runs[i + 1][0] - 1 if i + 1 < n_runs else n_chunks
        if first < 1 or last > n_chunks or last < first - 1:
            raise ValueError("corrupt MP4: stsc chunk runs out of order")
        for chunk in range(first - 1, last):
            pos = chunk_offsets[chunk]
            for _ in range(per_chunk):
                if len(offsets) == count:
                    break
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    if len(offsets) != count:
        raise ValueError(f"corrupt MP4: {count} samples in stsz, {len(offsets)} in the chunks")
    # a sample past the end of the file: an mdat cut short (the Demuxer
    # keeps those that start in the file)
    stts = _need(data, s, e, b"stts")
    n_stts = _u32(data, stts[0] + 4)
    if stts[0] + 8 + 8 * n_stts > stts[1]:
        raise ValueError("truncated stts")
    runs = [struct.unpack_from(">II", data, stts[0] + 8 + 8 * i) for i in range(n_stts)]
    duration = sum(c * d for c, d in runs)
    deltas = [d for c, d in runs for _ in range(c)]
    return offsets, sizes, duration, deltas


def _video_track(data: bytes, trak: Tuple[int, int], file_size: int,
                 movie: Sequence[int] = IDENTITY) -> Optional[Track]:
    mdia = _need(data, *trak, b"mdia")
    hdlr = _need(data, *mdia, b"hdlr")
    if data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
        return None
    mdhd = _need(data, *mdia, b"mdhd")
    version = data[mdhd[0]]
    timescale = _u32(data, mdhd[0] + (20 if version == 1 else 12))
    stbl = _need(data, *_need(data, *mdia, b"minf"), b"stbl")
    stsd = _need(data, *stbl, b"stsd")
    entry = stsd[0] + 8
    if entry + 8 > stsd[1]:
        raise ValueError("truncated stsd")
    size, fourcc = struct.unpack_from(">I4s", data, entry)
    if (fourcc != b"mp4v" and fourcc not in AVC_ENTRIES and fourcc not in HEVC_ENTRIES
            and fourcc not in MJPEG_ENTRIES):
        name = CODEC_NAMES.get(fourcc, f"codec {fourcc.decode('latin-1')!r}")
        raise ValueError(f"{name} video in an MP4 is not supported: the port reads MPEG-4 Part 2 "
                         f"(mp4v), as cv2.VideoWriter writes it, H.264 (avc1, avc3), H.265 "
                         f"(hvc1, hev1) and Motion JPEG (jpeg, mjpa)")
    if size < 86 or entry + size > stsd[1]:
        raise ValueError(f"corrupt MP4: short {fourcc.decode('latin-1')} sample entry")
    width, height = struct.unpack_from(">HH", data, entry + 32)
    codec = fourcc.decode("latin-1")
    if fourcc in MJPEG_ENTRIES:
        codec, dsi = "mjpeg", b""
    elif fourcc == b"mp4v":
        oti, dsi = parse_esds(data, *_need(data, entry + 86, entry + size, b"esds"))
        codec = "mjpeg" if oti == JPEG_OBJECT else codec
    elif fourcc in HEVC_ENTRIES:
        hvcc = _find(data, entry + 86, entry + size, b"hvcC")
        if hvcc is None:
            raise ValueError(f"corrupt MP4: an {HEVC_ENTRIES[fourcc]} sample entry without an "
                             f"hvcC box")
        codec, dsi = "hevc", data[hvcc[0]:hvcc[1]]
    else:
        avcc = _find(data, entry + 86, entry + size, b"avcC")
        if avcc is None:
            raise ValueError(f"corrupt MP4: an {AVC_ENTRIES[fourcc]} sample entry without an "
                             f"avcC box")
        dsi = data[avcc[0]:avcc[1]]
    offsets, sizes, duration, deltas = _sample_table(data, *stbl, file_size)
    if not timescale:
        raise ValueError("corrupt MP4: mdhd timescale of 0")
    fps = float(Fraction(timescale * len(sizes), duration)) if duration and sizes else 0.0
    cts = _ctts(data, *stbl, len(sizes))
    dts = [0] * len(sizes)
    for i in range(1, len(sizes)):
        dts[i] = dts[i - 1] + deltas[i - 1]
    pts = dts if cts is None else [t + c for t, c in zip(dts, cts)]
    _check_edits(data, trak, pts, timescale)
    delay = guess_video_delay(pts) if cts is not None and fourcc in AVC_ENTRIES else 0
    rotation = display_rotation(display_matrix(_matrix(data, *trak, b"tkhd", 40, 52), movie))
    return Track(width, height, fps, dsi, offsets, sizes, timescale, duration, codec, cts, delay,
                 rotation)


class Demuxer:
    """The first video track of an MP4 file; ``read(i)`` is sample i's bytes."""

    def __init__(self, path: str):
        self._f: BinaryIO = open(path, "rb")
        try:
            self.track = self._parse()
        except Exception:
            self._f.close()
            raise

    def _parse(self) -> Track:
        f = self._f
        f.seek(0, 2)
        file_size = self.file_size = f.tell()
        pos, moov, ftyp = 0, None, False
        while pos + 8 <= file_size:
            f.seek(pos)
            head = f.read(16)
            size, kind = struct.unpack_from(">I4s", head)
            hlen = 8
            if size == 1:
                if len(head) < 16:
                    raise ValueError("truncated MP4 box header")
                size, hlen = struct.unpack_from(">Q", head, 8)[0], 16
            elif size == 0:
                size = file_size - pos
            if size >= hlen and pos + size > file_size and kind == b"mdat":
                size = file_size - pos  # cut by the end of the file: its samples past it are lost
            if size < hlen or pos + size > file_size:
                raise ValueError(f"corrupt or truncated MP4: box {kind!r} of {size} bytes at "
                                 f"{pos} runs past the file's {file_size}")
            ftyp |= kind == b"ftyp"
            if kind == b"moof":
                raise ValueError("fragmented MP4 (moof) is not supported")
            if kind == b"moov":
                f.seek(pos + hlen)
                moov = f.read(size - hlen)
            pos += size
        if not ftyp and moov is None:
            raise ValueError("not an MP4 file (no ftyp or moov box)")
        if moov is None:
            raise ValueError("MP4 without a moov box (an unfinished recording?)")
        if _find(moov, 0, len(moov), b"mvex") is not None:
            raise ValueError("fragmented MP4 (mvex) is not supported")
        movie = _matrix(moov, 0, len(moov), b"mvhd", 36, 48)
        for kind, s, e in iter_boxes(moov):
            if kind == b"trak":
                track = _video_track(moov, (s, e), file_size, movie)
                if track is not None:
                    # an mdat cut by the end of the file (a recording cut
                    # short after its moov was written): FFmpeg reads the
                    # samples that start in the file, the last of them as
                    # far as it goes
                    kept = sum(1 for o in track.offsets if o < file_size)
                    del track.offsets[kept:], track.sizes[kept:]
                    return track
        raise ValueError("MP4 without a video track")

    def __len__(self) -> int:
        return len(self.track.sizes)

    @property
    def partial(self) -> bool:
        """Whether the last sample is cut by the end of the file."""
        t = self.track
        return bool(t.sizes) and t.offsets[-1] + t.sizes[-1] > self.file_size

    def read(self, i: int) -> bytes:
        """Sample i; the last one as far as the file goes when it is cut
        (``partial``), as FFmpeg's demuxer hands it over."""
        self._f.seek(self.track.offsets[i])
        data = self._f.read(self.track.sizes[i])
        if len(data) != self.track.sizes[i] and not (self.partial and i == len(self) - 1):
            raise ValueError("truncated MP4 sample")
        return data

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------------ muxer

def box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descriptor_bytes(tag: int, body: bytes) -> bytes:
    n, size = len(body), b""
    size = bytes([n & 0x7F])
    n >>= 7
    while n:
        size = bytes([0x80 | (n & 0x7F)]) + size
        n >>= 7
    return bytes([tag]) + size + body


def esds_box(dsi: bytes, bitrate: int = 0) -> bytes:
    config = _descriptor_bytes(0x04, struct.pack(">BB", MPEG4_VISUAL, 0x11) + bytes(3)
                               + struct.pack(">II", bitrate, bitrate)
                               + _descriptor_bytes(0x05, dsi))
    es = _descriptor_bytes(0x03, struct.pack(">HB", 1, 0) + config
                           + _descriptor_bytes(0x06, b"\x02"))
    return full_box(b"esds", 0, 0, es)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def visual_sample_entry(fourcc: bytes, width: int, height: int, *children: bytes) -> bytes:
    """A VisualSampleEntry box (``mp4v``, ``avc1``, ...) with its child boxes."""
    return box(fourcc, bytes(6), struct.pack(">H", 1), bytes(16),
               struct.pack(">HHIII", width, height, 0x480000, 0x480000, 0),
               struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 0x18, -1), *children)


def build_moov(width: int, height: int, dsi: bytes, timescale: int, delta: int,
               sizes: Sequence[int], keys: Sequence[int], chunk_offsets: Sequence[int],
               samples_per_chunk: int, entry: Optional[bytes] = None,
               cts: Optional[Sequence[int]] = None) -> bytes:
    """The ``moov`` of one ``mp4v`` track: samples of ``sizes`` laid out in
    chunks of ``samples_per_chunk`` at ``chunk_offsets`` (the last chunk
    may be short), ``keys`` the 1-based key samples; ``co64`` once an
    offset passes 4 GiB, else ``stco``.  ``entry``, when given, is the
    sample entry box in place of ``mp4v`` + ``esds(dsi)``.  ``cts``, when
    given, are the samples' composition offsets (``ctts`` version 0), and
    an ``edts``/``elst`` starts the presentation at the first sample's."""
    n = len(sizes)
    duration = n * delta
    movie_ms = duration * 1000 // timescale
    mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms),
                    struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                    struct.pack(">I", 2))
    tkhd = full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                    struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX,
                    struct.pack(">II", width << 16, height << 16))
    mdhd = full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, duration),
                    struct.pack(">HH", 0x55C4, 0))  # language "und"
    hdlr = full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12), b"VideoHandler\0")
    vmhd = full_box(b"vmhd", 0, 1, bytes(8))
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1), full_box(b"url ", 0, 1)))
    if entry is None:
        entry = visual_sample_entry(b"mp4v", width, height, esds_box(dsi))
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stts = full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta) if n else struct.pack(">I", 0))
    stss = full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys))
    n_chunks = len(chunk_offsets)
    tail = n - (n_chunks - 1) * samples_per_chunk
    runs = [] if not n_chunks else [(1, tail)] if n_chunks == 1 else \
        [(1, samples_per_chunk)] + ([(n_chunks, tail)] if tail != samples_per_chunk else [])
    stsc = full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)),
                    *(struct.pack(">III", first, per, 1) for first, per in runs))
    stsz = full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes))
    if chunk_offsets and max(chunk_offsets) >= 1 << 32:
        stco = full_box(b"co64", 0, 0, struct.pack(f">I{n_chunks}Q", n_chunks, *chunk_offsets))
    else:
        stco = full_box(b"stco", 0, 0, struct.pack(f">I{n_chunks}I", n_chunks, *chunk_offsets))
    ctts, edts = b"", b""
    if cts is not None:
        runs: List[List[int]] = []
        for c in cts:
            if runs and runs[-1][1] == c:
                runs[-1][0] += 1
            else:
                runs.append([1, c])
        ctts = full_box(b"ctts", 0, 0, struct.pack(">I", len(runs)),
                        *(struct.pack(">II", r, c) for r, c in runs))
        edts = box(b"edts", full_box(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie_ms,
                                                                  cts[0] if n else 0, 1, 0)))
    stbl = box(b"stbl", stsd, stts, ctts, stss, stsc, stsz, stco)
    trak = box(b"trak", tkhd, edts, box(b"mdia", mdhd, hdlr, box(b"minf", vmhd, dinf, stbl)))
    return box(b"moov", mvhd, trak)


FTYP = box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")


#: samples per chunk of the muxer: one I-VOP interval of the encoder
SAMPLES_PER_CHUNK = 12


class Muxer:
    """Writes one ``mp4v`` track: ``add(sample, key)`` per frame, then
    ``close()`` writes the ``moov``.  Samples go in chunks of
    ``SAMPLES_PER_CHUNK``."""

    def __init__(self, path: str, width: int, height: int, dsi: bytes, timescale: int,
                 delta: int):
        self.width, self.height, self.dsi = width, height, dsi
        self.timescale, self.delta = timescale, delta
        self.sizes: List[int] = []
        self.keys: List[int] = []
        self.chunk_offsets: List[int] = []
        self._f = open(path, "wb")
        self._f.write(FTYP)
        # a 16-byte mdat header, its 64-bit size filled in on close
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))
        self._pos = self._mdat + 16
        self.closed = False

    def add(self, sample: bytes, key: bool) -> None:
        if len(self.sizes) % SAMPLES_PER_CHUNK == 0:
            self.chunk_offsets.append(self._pos)
        self._f.write(sample)
        self._pos += len(sample)
        self.sizes.append(len(sample))
        if key:
            self.keys.append(len(self.sizes))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self._f.write(build_moov(self.width, self.height, self.dsi, self.timescale,
                                     self.delta, self.sizes, self.keys, self.chunk_offsets,
                                     SAMPLES_PER_CHUNK))
            self._f.seek(self._mdat + 8)
            self._f.write(struct.pack(">Q", self._pos - self._mdat))
        finally:
            self._f.close()


def rate(fps: float) -> Tuple[int, int]:
    """(timescale, ticks per frame) of a frame rate: 30.0 -> (30, 1),
    29.97 -> (30000, 1001)."""
    r = Fraction(fps).limit_denominator(1001)
    if r <= 0 or r.numerator > 65535:
        raise ValueError(f"frame rate {fps} out of range")
    return r.numerator, r.denominator


__all__ = ["Demuxer", "Muxer", "Track", "build_moov", "box", "full_box", "esds_box",
           "parse_esds", "iter_boxes", "rate", "visual_sample_entry", "guess_video_delay", "FTYP",
           "CODEC_NAMES", "AVC_ENTRIES", "HEVC_ENTRIES", "MJPEG_ENTRIES", "MAX_REORDER_DELAY"]
