"""The AVI container of the demo's video, without cv2 or FFmpeg: a demuxer
that finds the frames of the first video stream as FFmpeg's ``avi``
demuxer finds them, and a muxer that writes the layout FFmpeg's ``avi``
muxer writes for ``cv2.VideoWriter``.

``Demuxer(path)`` reads ``RIFF AVI `` with its ``hdrl`` (``avih``, one
``strl`` per stream with ``strh``, ``strf`` and an OpenDML ``indx``), and
takes the first stream whose ``strh`` is ``vids``, whatever its number;
other streams (``##wb`` audio, subtitles) and ``JUNK`` are skipped.  The
codec comes from the ``strf`` BITMAPINFOHEADER's compression tag
(``CODECS``), the rate is ``dwRate / dwScale``.  Its frames, as FFmpeg's
``avi_read_packet`` takes them:

- an interleaved file is read in file order, chunk by chunk, from the
  ``movi`` list to the end of the file, through ``rec `` lists, ``ix##``
  and ``idx1`` chunks and ``RIFF AVIX`` extensions (``avi_sync``); a video
  chunk of 0 bytes is skipped, and a chunk that runs past the end of the
  file (the last one of a recording cut by a power loss) ends the stream
  (``truncated`` counts its bytes).  FFmpeg drops that chunk when the
  RIFF's size is 0 or within the file; when the size runs past the file
  it hands the decoder the partial chunk, and so does the demuxer
  (``partial``): a Motion JPEG decoder decodes what it holds, an ``mp4v``
  or H.264 decoder what it holds and conceals the rest as FFmpeg does;
- the index, an OpenDML super index (``indx``) over standard indexes
  (``ix##``) or else ``idx1`` (its offsets relative to ``movi`` or to the
  file, told apart as ``avi_read_idx1`` tells them; an OpenDML index that
  cannot be read is passed over, as FFmpeg passes it), gives each frame's
  keyframe flag, and the frames themselves where FFmpeg reads the file as
  non-interleaved (``guess_ni_flag``: streams that do not overlap in the
  file, or an index entry repeated);
- a file without an index is read by the same scan.

Codecs the port lacks (raw ``DIB `` frames, H.265, MJPEG-B, ...) and
corrupt structure (a header chunk past its list or the file, a stream
header shorter than 56 bytes, no ``movi`` list) raise a
``ValueError`` that names them.

``Muxer(path, width, height, fourcc, rate, scale)`` writes one video
stream: ``hdrl`` with ``avih``, ``strh``/``strf`` tagged ``fourcc``, the
``JUNK`` that FFmpeg keeps for an OpenDML ``indx`` and ``odml``/``dmlh``,
a ``LIST INFO``, then ``00dc`` chunks in ``movi`` and an ``idx1`` with
``AVIIF_KEYFRAME`` on key samples.  When a ``RIFF`` passes ``RIFF_LIMIT``
(1 GiB, FFmpeg's ``AVI_MAX_RIFF_SIZE``) it closes it with an ``ix00`` and
``idx1`` and goes on in ``RIFF AVIX`` extensions, and at the end turns
the ``JUNK`` into the ``indx`` super index and the ``odml`` list, as
FFmpeg does.
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import BinaryIO, Dict, List, Optional, Tuple

#: compression tags -> the port's decoder (FFmpeg's bmp tags, upper-cased)
CODECS = {
    **dict.fromkeys(("MP4V", "FMP4", "XVID", "DIVX", "DX50", "M4S2", "MP4S", "3IV2", "RMP4",
                     "DIV1", "BLZ0", "UMP4", "SMP4", "XVIX", "DXGM", "HDX4", "FVFW"), "mp4v"),
    **dict.fromkeys(("H264", "X264", "AVC1", "DAVC", "VSSH", "Q264", "V264", "GAVC"), "h264"),
    **dict.fromkeys(("HEVC", "H265", "X265", "HVC1", "HEV1"), "hevc"),
    **dict.fromkeys(("MJPG", "AVRN", "ACDV", "QIVG", "SLMJ", "CJPG", "IJPG", "JPGL", "DMB1",
                     "MJPA", "AVI1"), "mjpeg"),
}
#: tags the demuxer names when it refuses them
CODEC_NAMES = {
    "MJPB": "MJPEG-B (mjpb)",
    "DIB ": "raw DIB frames", "RGB ": "raw RGB frames", "RAW ": "raw frames",
    "MPG2": "MPEG-2 video", "MPG1": "MPEG-1 video", "WMV3": "WMV9 (WMV3)", "VP80": "VP8",
    "VP90": "VP9", "AV01": "AV1", "DVSD": "DV", "MJ2C": "Motion JPEG 2000",
    "LJPG": "lossless JPEG (LJPG)", "MP42": "MS MPEG-4 v2", "DIV3": "DivX 3 (MS MPEG-4 v3)",
    "MP43": "MS MPEG-4 v3",
}
#: the RIFF size past which the muxer starts an ``AVIX`` extension
#: (FFmpeg's AVI_MAX_RIFF_SIZE); a test lowers it
RIFF_LIMIT = 1 << 30
#: entries of the OpenDML super index (FFmpeg's AVI_MASTER_INDEX_SIZE)
MASTER_INDEX_SIZE = 256
#: AVIIF_KEYFRAME of idx1 (FFmpeg's AVIIF_INDEX)
KEYFRAME = 0x10


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _stream_index(fourcc: bytes) -> int:
    """The stream number of a chunk id ``##xx``, or -1."""
    if len(fourcc) < 2 or not (48 <= fourcc[0] <= 57 and 48 <= fourcc[1] <= 57):
        return -1
    return (fourcc[0] - 48) * 10 + fourcc[1] - 48


class Stream:
    """The video stream: number, codec, size, rate and decoder config."""

    def __init__(self, number: int, tag: str, codec: str, width: int, height: int,
                 rate: int, scale: int, extradata: bytes):
        self.number, self.tag, self.codec = number, tag, codec
        self.width, self.height = width, height
        self.rate, self.scale = rate, scale
        self.fps = float(Fraction(rate, scale)) if rate and scale else 0.0
        #: bytes after the BITMAPINFOHEADER in ``strf`` (a codec's headers)
        self.extradata = extradata


class Demuxer:
    """The first video stream of an AVI file; ``read(i)`` is frame i's
    bytes, ``keys[i]`` whether the index marks it a keyframe."""

    def __init__(self, path: str):
        self._f: BinaryIO = open(path, "rb")
        try:
            self._parse()
        except Exception:
            self._f.close()
            raise

    # -- structure

    def _read_at(self, pos: int, n: int) -> bytes:
        self._f.seek(pos)
        return self._f.read(n)

    def _header(self, pos: int) -> Tuple[bytes, int]:
        head = self._read_at(pos, 8)
        if len(head) < 8:
            raise ValueError("truncated AVI: a chunk header past the end of the file")
        return head[:4], _u32(head, 4)

    def _parse(self) -> None:
        f = self._f
        f.seek(0, 2)
        self.file_size = size = f.tell()
        head = self._read_at(0, 12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] not in (b"AVI ", b"AVIX"):
            raise ValueError("not an AVI file (no RIFF AVI header)")
        if head[8:12] != b"AVI ":
            raise ValueError("corrupt AVI: the first RIFF is an AVIX extension")
        # a recording cut short may leave the RIFF size unwritten or too large
        riff_size = _u32(head, 4)
        riff_end = min(8 + riff_size, size) if riff_size else size
        # FFmpeg's avi->fsize: the RIFF's declared end when it runs past the
        # file (a recording cut short after its sizes were written), within
        # which a chunk cut by the end of the file is still read
        self.declared_end = max(size, 8 + riff_size)
        streams: List[Tuple[bytes, bytes, bytes]] = []  # (strh, strf, indx)
        self.movi: Optional[int] = None
        pos = 12
        while pos + 8 <= riff_end:
            kind, n = self._header(pos)
            if kind == b"LIST":
                list_type = self._read_at(pos + 8, 4)
                if list_type == b"movi":
                    self.movi = pos + 8  # FFmpeg's movi_list: the 'movi' fourcc
                    break
                if pos + 8 + n > size:
                    raise ValueError(f"corrupt AVI: LIST {list_type!r} of {n} bytes runs past "
                                     f"the file")
                if list_type == b"hdrl":
                    streams = self._hdrl(pos + 12, pos + 8 + n)
            elif pos + 8 + n > size:
                raise ValueError(f"corrupt AVI: chunk {kind!r} of {n} bytes runs past the file")
            pos += 8 + n + (n & 1)
        if not streams:
            raise ValueError("corrupt AVI: no hdrl list with a stream header")
        if self.movi is None:
            raise ValueError("corrupt AVI: no movi list")
        self.n_streams = len(streams)
        self.stream = self._video_stream(streams)
        self._find_frames(streams[self.stream.number][2])

    def _children(self, start: int, end: int):
        """(fourcc, payload start, size) of each chunk in [start, end)."""
        pos = start
        while pos + 8 <= end:
            kind, n = self._header(pos)
            if pos + 8 + n > end:
                raise ValueError(f"corrupt AVI: chunk {kind!r} of {n} bytes runs past its list")
            yield kind, pos + 8, n
            pos += 8 + n + (n & 1)

    def _hdrl(self, start: int, end: int) -> List[Tuple[bytes, bytes, bytes]]:
        streams = []
        for kind, s, n in self._children(start, end):
            if kind != b"LIST" or self._read_at(s, 4) != b"strl":
                continue
            strh = strf = indx = b""
            for k, cs, cn in self._children(s + 4, s + n):
                if k == b"strh":
                    strh = self._read_at(cs, cn)
                elif k == b"strf":
                    strf = self._read_at(cs, cn)
                elif k == b"indx":
                    indx = self._read_at(cs, cn)
            if len(strh) < 56:
                raise ValueError(f"corrupt AVI: a stream header (strh) of {len(strh)} bytes, "
                                 f"under 56")
            streams.append((strh, strf, indx))
        return streams

    def _video_stream(self, streams) -> Stream:
        for number, (strh, strf, _) in enumerate(streams):
            if strh[:4] != b"vids":
                continue
            if len(strf) < 40:
                raise ValueError(f"corrupt AVI: a video stream format (strf) of {len(strf)} "
                                 f"bytes, under a BITMAPINFOHEADER's 40")
            bi_size, width, height = struct.unpack_from("<Iii", strf, 0)
            compression = strf[16:20]
            tag = compression.decode("latin-1")
            if compression == b"\0\0\0\0":
                tag = "DIB "
            key = tag.upper()
            if key not in CODECS:
                name = CODEC_NAMES.get(key, f"codec {tag!r}")
                raise ValueError(f"{name} video in an AVI is not supported: the port reads "
                                 f"MPEG-4 Part 2 (mp4v, XVID, DIVX, ...), H.264, H.265 and Motion "
                                 f"JPEG")
            scale, rate = struct.unpack_from("<II", strh, 20)
            extradata = strf[max(40, min(bi_size, len(strf))):]
            return Stream(number, tag, CODECS[key], width, abs(height), rate, scale, extradata)
        raise ValueError("AVI without a video stream")

    # -- frames

    def _find_frames(self, indx: bytes) -> None:
        index = None
        if indx:
            try:
                index = self._odml_index(indx)
            except ValueError:
                index = None  # FFmpeg goes on without an index it cannot read
        if index is None:
            index = self._idx1()
        scanned = self._scan()
        self.indexed = index is not None
        self.non_interleaved = index is not None and self._non_interleaved(index)
        if self.non_interleaved:
            mine = [(p, n, k) for s, p, n, k in index[0]
                    if s == self.stream.number and p + 8 + n <= self.file_size]
            self.partial = False  # the index's chunks are whole
            self.offsets = [p + 8 for p, _, _ in mine]
            self.sizes = [n for _, n, _ in mine]
            self.keys = [k for _, _, k in mine]
            return
        self.offsets = [p + 8 for p, _ in scanned]
        self.sizes = [n for _, n in scanned]
        flags = {} if index is None else {p: k for s, p, _, k in index[0]
                                          if s == self.stream.number}
        self.keys = [flags.get(p, True) for p, _ in scanned]

    def _chunks(self):
        """(position, fourcc, size) of each chunk from ``movi`` on, as
        FFmpeg's ``avi_sync`` meets them: into ``rec ``, ``movi`` and
        ``AVIX`` lists, to the end of the file.  A last chunk cut by the end
        of the file ends them (``truncated``: its bytes in the file); it is
        the last one met, cut short (``partial``), when the RIFF's declared
        size holds it, as FFmpeg hands it to the decoder, else dropped."""
        pos, end = self.movi + 4, self.file_size
        self.truncated, self.partial = 0, False
        while pos + 8 <= end:
            kind, n = self._header(pos)
            if kind in (b"LIST", b"RIFF"):  # rec, movi, AVIX: step in
                pos += 12
                continue
            if pos + 8 + n > end:
                self.truncated = end - pos - 8
                if pos + 8 + n <= self.declared_end and self.truncated:
                    self.partial = True
                    yield pos, kind, self.truncated
                return
            yield pos, kind, n
            pos += 8 + n
            # chunks are padded to even sizes; a writer that did not pad
            # leaves the next header at the odd position (avi_sync tries both)
            if n & 1 and not self._looks_like_chunk(pos + 1) and self._looks_like_chunk(pos):
                continue
            pos += n & 1

    def _scan(self) -> List[Tuple[int, int]]:
        """(chunk position, size) of the video stream's non-empty chunks."""
        video = self.stream.number
        return [(p, n) for p, kind, n in self._chunks()
                if _stream_index(kind) == video and kind[2:] != b"ix" and n]

    def _looks_like_chunk(self, pos: int) -> bool:
        head = self._read_at(pos, 8)
        if len(head) < 8:
            return False
        kind = head[:4]
        return (kind in (b"LIST", b"RIFF", b"JUNK", b"idx1", b"indx")
                or (_stream_index(kind) >= 0 and all(32 <= c < 127 for c in kind[2:]))
                or kind[:2] == b"ix")

    def _idx1(self):
        """idx1's entries [(stream, chunk position, size, key)] of non-empty
        chunks, and whether an entry repeated, as ``avi_read_idx1`` reads
        them; None without an idx1."""
        pos = self.movi - 8
        _, movi_size = self._header(pos)
        pos = self.movi + movi_size if movi_size else self.file_size
        pos += pos & 1
        found = None
        while pos + 8 <= self.file_size:
            kind, n = self._header(pos)
            if kind == b"idx1":
                found = (pos + 8, min(n, self.file_size - pos - 8))
                break
            pos += 8 + n + (n & 1)
        if found is None or found[1] < 16:
            return None
        raw = self._read_at(*found)
        first_packet = next((p for p, kind, _ in self._chunks()
                             if 0 <= _stream_index(kind) < self.n_streams and kind[2:] != b"ix"),
                            None)
        entries, repeated, offset, first = [], False, 0, True
        last_pos = last_added = -1
        for i in range(len(raw) // 16):
            tag, flags, p, n = struct.unpack_from("<4sIII", raw, 16 * i)
            s = _stream_index(tag)
            if s < 0 or s >= self.n_streams or tag[2:] == b"pc":
                continue
            if first and first_packet is not None:
                if self.movi + 4 != p or p + 500 > first_packet:
                    offset = first_packet - p
                first = False
            p += offset
            repeated |= last_pos == p
            if last_added != p and n:
                entries.append((s, p, n, bool(flags & KEYFRAME)))
                last_added = p
            last_pos = p
        return entries, repeated

    def _odml_index(self, indx: bytes, depth: int = 0):
        """The OpenDML indexes' entries, as ``read_odml_index`` reads a
        super index (``indx``) and its standard indexes (``ix##``); None
        when the super index is empty or not one FFmpeg reads."""
        entries: List[Tuple[int, int, int, bool]] = []
        repeated = self._odml_entries(indx, entries, depth)
        return (entries, repeated) if entries else None

    def _odml_entries(self, data: bytes, entries, depth: int) -> bool:
        if len(data) < 24:
            raise ValueError("corrupt AVI: a truncated OpenDML index")
        per_entry, sub_type, index_type, in_use, chunk_id, base = struct.unpack_from(
            "<HBBI4sQ", data, 0)
        stream = _stream_index(chunk_id)
        if stream < 0 or stream >= self.n_streams or sub_type or index_type > 1 or \
                (index_type and per_entry != 2):
            raise ValueError("corrupt AVI: an OpenDML index of another kind or stream")
        if depth > 8:
            raise ValueError("corrupt AVI: OpenDML indexes nested too deeply")
        repeated = False
        if index_type == 0:  # a super index: (offset, size, duration) of ix## chunks
            if 24 + 16 * in_use > len(data):
                raise ValueError("corrupt AVI: an OpenDML super index past its chunk")
            for i in range(in_use):
                offset, n, _ = struct.unpack_from("<QII", data, 24 + 16 * i)
                if offset + 8 > self.file_size:
                    raise ValueError("corrupt AVI: an OpenDML index past the end of the file")
                _, size = self._header(offset)
                chunk = self._read_at(offset + 8, size)
                if len(chunk) < size:
                    raise ValueError("truncated AVI: an OpenDML index past the end of the file")
                repeated |= self._odml_entries(chunk, entries, depth + 1)
            return repeated
        if base >= self.file_size:
            raise ValueError("corrupt AVI: an OpenDML index based past the end of the file")
        if 24 + 8 * in_use > len(data):
            raise ValueError("corrupt AVI: an OpenDML standard index past its chunk")
        last = -1
        for i in range(in_use):
            off, n = struct.unpack_from("<II", data, 24 + 8 * i)
            p = base + off - 8
            repeated |= last == p or p == base - 8
            if last != p and n & 0x7FFFFFFF:
                entries.append((stream, p, n & 0x7FFFFFFF, not n & 0x80000000))
            last = p
        return repeated

    def _non_interleaved(self, index) -> bool:
        """FFmpeg's ``guess_ni_flag``, without its drift test: an index
        entry repeated, or streams whose chunks do not overlap in the file."""
        entries, repeated = index
        if repeated:
            return True
        spans: Dict[int, List[int]] = {}
        for s, p, _, _ in entries:
            spans.setdefault(s, []).append(p)
        if len(spans) < 2:
            return False
        return max(v[0] for v in spans.values()) > min(v[-1] for v in spans.values())

    def __len__(self) -> int:
        return len(self.sizes)

    def read(self, i: int) -> bytes:
        data = self._read_at(self.offsets[i], self.sizes[i])
        if len(data) != self.sizes[i]:
            raise ValueError("truncated AVI frame")
        return data

    def close(self) -> None:
        self._f.close()


def mpeg4_config(extradata: bytes, first: bytes) -> bytes:
    """An ``mp4v``-family stream's decoder configuration: ``strf``'s extra
    bytes and the headers in band before the first frame's VOP (start code
    0x000001B6)."""
    vop = first.find(b"\x00\x00\x01\xb6")
    return extradata + (first if vop < 0 else first[:vop])


# ------------------------------------------------------------------ muxer

def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack("<4sI", kind, len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _rate(fps: float) -> Tuple[int, int]:
    """(dwRate, dwScale) of a frame rate: 30.0 -> (30, 1), 29.97 ->
    (30000, 1001)."""
    r = Fraction(fps).limit_denominator(1001)
    if r <= 0:
        raise ValueError(f"frame rate {fps} out of range")
    return r.numerator, r.denominator


#: the software the INFO list names
SOFTWARE = b"adas_tpu_torch\0"


class Muxer:
    """Writes one video stream of already-encoded samples tagged
    ``fourcc`` (``mp4v``, ``MJPG``, ``H264``, ...): ``add(sample, key)``
    per frame, then ``close()`` fills in the counts and writes the index."""

    def __init__(self, path: str, width: int, height: int, fourcc: bytes, fps: float = 30.0):
        if len(fourcc) != 4:
            raise ValueError(f"an AVI codec tag has 4 bytes, got {fourcc!r}")
        self.width, self.height, self.fourcc = width, height, fourcc
        self.rate, self.scale = _rate(fps)
        self.closed = False
        self._f = open(path, "wb")
        self._write_header()
        self._riffs: List[int] = [0]  # each RIFF's start
        self._ix: List[Tuple[int, int, int]] = []  # (offset, size, frames so far) per ix00
        self._entries: List[Tuple[int, int, bool]] = []  # this RIFF's (pos rel. movi, len, key)
        self._count = self._max_size = self._first_riff_frames = 0

    def _write_header(self) -> None:
        w, h = self.width, self.height
        avih = struct.pack("<10I16x", round(1e6 * self.scale / self.rate), 0, 0, 0x910, 0, 0, 1,
                           1 << 20, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", self.fourcc, 0, 0, 0, 0, self.scale,
                           self.rate, 0, 0, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, self.fourcc, w * h * 3, 0, 0, 0, 0)
        # FFmpeg's OpenDML placeholders, JUNK until the file needs them
        indx = struct.pack("<HBBI4s12x", 4, 0, 0, 0, b"00dc") + bytes(16 * MASTER_INDEX_SIZE)
        odml = b"odml" + chunk(b"dmlh", bytes(248))
        strl = b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf) + chunk(b"JUNK", indx)
        hdrl = b"hdrl" + chunk(b"avih", avih) + chunk(b"LIST", strl) + chunk(b"JUNK", odml)
        info = b"INFO" + chunk(b"ISFT", SOFTWARE)
        head = (b"RIFF" + bytes(4) + b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", info)
                + chunk(b"JUNK", bytes(1016)) + b"LIST" + bytes(4) + b"movi")
        self._avih = head.index(b"avih") + 8  # avih's payload
        self._strh = head.index(b"strh") + 8  # strh's payload
        self._indx = head.index(b"JUNK", self._strh)  # the JUNK kept for the indx
        self._odml = head.index(b"odml") - 8  # the JUNK kept for the odml list
        self._f.write(head)
        self._movi = len(head) - 4  # the 'movi' fourcc
        self._pos = len(head)

    def add(self, sample: bytes, key: bool) -> None:
        if self.closed:
            raise ValueError("the AVI muxer is closed")
        if self._pos - self._riffs[-1] - 8 > RIFF_LIMIT:
            self._next_riff()
        self._entries.append((self._pos - self._movi, len(sample), key))
        self._f.write(chunk(b"00dc", sample))
        self._pos += 8 + len(sample) + (len(sample) & 1)
        self._count += 1
        self._max_size = max(self._max_size, len(sample))

    def _write_ix(self) -> None:
        """This RIFF's ``ix00`` standard index, and its super index entry."""
        body = struct.pack("<HBBI4sQI", 2, 0, 1, len(self._entries), b"00dc", self._movi, 0)
        body += b"".join(struct.pack("<II", p + 8, n | (0 if k else 0x80000000))
                         for p, n, k in self._entries)
        self._ix.append((self._pos, 8 + len(body), self._count))
        self._f.write(chunk(b"ix00", body))
        self._pos += 8 + len(body)
        # the JUNK becomes the super index as soon as it has an entry, as
        # FFmpeg's update_odml_entry makes it
        f = self._f
        f.seek(self._indx)
        f.write(b"indx")
        f.seek(self._indx + 8 + 4)
        f.write(struct.pack("<I", len(self._ix)))
        f.seek(self._indx + 8 + 24 + 16 * (len(self._ix) - 1))
        f.write(struct.pack("<QII", *self._ix[-1]))
        f.seek(self._pos)

    def _write_idx1(self) -> None:
        body = b"".join(struct.pack("<4sIII", b"00dc", KEYFRAME if k else 0, p, n)
                        for p, n, k in self._entries)
        self._f.write(chunk(b"idx1", body))
        self._pos += 8 + len(body)
        self._first_riff_frames = self._count

    def _end_list(self, start: int) -> None:
        """Writes the size of the RIFF or LIST whose fourcc is at ``start``."""
        self._f.seek(start + 4)
        self._f.write(struct.pack("<I", self._pos - start - 8))
        self._f.seek(self._pos)

    def _next_riff(self) -> None:
        self._write_ix()
        self._end_list(self._movi - 8)
        if len(self._riffs) == 1:
            self._write_idx1()
        self._end_list(self._riffs[-1])
        self._riffs.append(self._pos)
        self._f.write(b"RIFF" + bytes(4) + b"AVIXLIST" + bytes(4) + b"movi")
        self._movi = self._pos + 20
        self._pos += 24
        self._entries = []

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            f = self._f
            if len(self._riffs) == 1:
                self._end_list(self._movi - 8)
                self._write_idx1()
                self._end_list(0)
            else:
                self._write_ix()
                self._end_list(self._movi - 8)
                self._end_list(self._riffs[-1])
                # the odml JUNK becomes the list that counts every frame
                f.seek(self._odml)
                f.write(b"LIST")
                f.seek(self._odml + 8 + 12)
                f.write(struct.pack("<I", self._count))
            f.seek(self._avih + 16)
            f.write(struct.pack("<I", self._first_riff_frames))
            f.seek(self._strh + 32)
            f.write(struct.pack("<II", self._count, self._max_size))
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["Demuxer", "Muxer", "Stream", "CODECS", "CODEC_NAMES", "RIFF_LIMIT", "chunk",
           "mpeg4_config"]
