"""Video I/O without cv2: MP4 (``.mp4``, ``.m4v``, ``.mov``) and AVI
(``.avi``) with MPEG-4 Part 2, H.264 or Motion JPEG video, raw H.264 Annex
B streams (``.h264``, ``.264``), and YUV4MPEG2 (``.y4m``) 4:2:0 streams.

The JAX package reads and writes video through ``cv2.VideoCapture`` /
``cv2.VideoWriter`` (fourcc ``mp4v``, 30 fps, the container the suffix
names); the card's host has neither cv2 nor a codec.  ``open_reader(path)``
and ``open_writer(path, width, height, fps)`` pick the format by the
suffix:

- MP4: ``render/mp4.py`` (the container), ``render/mpeg4.py`` (the
  ``mp4v`` decoder and encoder, ``native/mpeg4.cpp``), ``render/h264.py``
  (the H.264 decoder, ``native/h264.cpp``) and ``render/mjpeg.py`` (the
  Motion JPEG decoder, ``native/mjpeg.cpp``).  ``MP4Reader`` takes the
  ``mp4v`` streams of cv2, the port, XviD and DivX (Simple and Advanced
  Simple: B-VOPs, DivX's packed B-VOPs, 4MV, quarter-sample, MPEG
  quantisation, video packets; in FFmpeg's delay and order), the I/P/B
  H.264 of dash-cams, phones and FFmpeg's muxer (``ctts``,
  ``edts``/``elst``) and Motion JPEG (``jpeg``, ``mjpa``, and ``mp4v``
  entries of object type 0x6C, as cv2 writes ``MJPG`` into an ``.mp4``),
  giving the frames cv2 gives in cv2's order and count; other codecs, and
  tools the decoders refuse, raise a ``ValueError`` that names them.
  ``MP4Writer`` writes an I-VOP every 12 frames (cv2's interval) and
  P-VOPs between at a fixed quantiser; cv2 reads its files.
- AVI: ``render/avi.py`` (the container).  ``AVIReader`` takes the first
  video stream of ``mp4v``/``XVID``/``DIVX``-family (the fourcc passed to
  the decoder, which FFmpeg reads for its XviD and DivX workarounds),
  H.264 (Annex B chunks) or Motion JPEG, indexed (``idx1``, OpenDML) or
  not, as cv2 reads them; a last chunk cut by the end of the file is
  decoded as far as it goes where FFmpeg hands it over, the rest of the
  picture concealed for ``mp4v`` and H.264 as FFmpeg conceals it (and any
  damaged or lost slice or video packet with it, ``native/
  error_resilience.h``); ``AVIWriter`` writes what
  ``MP4Writer`` writes in FFmpeg's AVI layout, the VOS/VOL headers in band
  before each I-VOP, as cv2 writes an ``.avi``.
- H.264 Annex B: ``AnnexBReader``, read only, split into access units at
  each picture's first slice; the rate of the SPS's VUI timing, else 25
  (FFmpeg's for a raw stream).

The H.264 readers first decode the stream's opening access units as
FFmpeg's stream probe does (``render/h264.probe_delay``, from the delay an
MP4's ``ctts`` shows, else 0), so that the decode proper starts from cv2's
reorder delay: FFmpeg drops a B picture that comes after a later one was
output, and which pictures that is depends on the delay.
- Y4M: raw I420 frames behind a text header.  ``Y4MReader`` takes the
  ``C420``, ``C420jpeg``, ``C420mpeg2`` and ``C420paldv`` chroma tags
  (all decoded alike, nearest chroma upsampling as cv2's) or none, and
  the ``F`` rate.

Both writers encode each BGR frame with ``ops/preprocess.bgr_to_i420``
(``cv2.cvtColor(COLOR_BGR2YUV_I420)`` to the bit), and the readers decode
I420 with ``native/draw.i420_to_bgr`` (``cv2.cvtColor(COLOR_YUV2BGR_I420)``
to the bit).  Motion JPEG frames are full-range ``yuvj`` planes, 4:2:2 as
often as 4:2:0: their ``read()`` converts them as cv2's swscale does
(``render/mjpeg.Decoder.bgr``), ``read_planes()`` gives them as decoded,
and ``read_i420()`` refuses them rather than pass them off as I420.
Frame sides must be even, except a Motion JPEG input's.
"""
from __future__ import annotations

import os
from collections import deque
from fractions import Fraction
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np

from ..native.draw import i420_to_bgr
from ..ops.preprocess import bgr_to_i420
from . import avi, h264, mjpeg, mp4, mpeg4

MAGIC = b"YUV4MPEG2"
CHROMA_420 = ("420", "420jpeg", "420mpeg2", "420paldv")
Y4M_SUFFIXES = (".y4m",)
MP4_SUFFIXES = (".mp4", ".m4v", ".mov")
AVI_SUFFIXES = (".avi",)
H264_SUFFIXES = (".h264", ".264")
#: the rate of a raw H.264 stream without VUI timing (FFmpeg's default)
H264_FPS = 25.0
#: bytes an Annex B reader takes from the file at a time
CHUNK = 1 << 20
#: the rate of an MP4 or AVI output, as the JAX package's cv2.VideoWriter writes it
MP4_FPS = 30.0


def _suffix(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def _check_path(path: str, suffixes) -> None:
    if _suffix(path) not in suffixes:
        raise ValueError(
            f"{path}: the port reads and writes MP4 ({', '.join(MP4_SUFFIXES)}) and AVI "
            f"({', '.join(AVI_SUFFIXES)}) with MPEG-4 Part 2 video (H.264 and Motion JPEG read "
            f"too) and YUV4MPEG2 ({', '.join(Y4M_SUFFIXES)}) video, and reads raw H.264 "
            f"({', '.join(H264_SUFFIXES)}); this class takes {', '.join(suffixes)} "
            f"(open_reader / open_writer pick by the suffix)")


def output_fps(path: str, input_fps: float) -> float:
    """The rate the demo writes ``path`` at: 30.0 for an MP4 or an AVI, as
    the JAX package's writer; a ``.y4m`` (the port's own format) keeps the
    input's."""
    return MP4_FPS if _suffix(path) in MP4_SUFFIXES + AVI_SUFFIXES else input_fps


def open_reader(path: str):
    """An ``MP4Reader``, ``AVIReader``, ``AnnexBReader`` or ``Y4MReader``
    by the suffix; any other raises."""
    if _suffix(path) in MP4_SUFFIXES:
        return MP4Reader(path)
    if _suffix(path) in AVI_SUFFIXES:
        return AVIReader(path)
    if _suffix(path) in H264_SUFFIXES:
        return AnnexBReader(path)
    _check_path(path, Y4M_SUFFIXES + MP4_SUFFIXES + AVI_SUFFIXES)
    return Y4MReader(path)


def open_writer(path: str, width: int, height: int, fps: float = 30.0):
    """An ``MP4Writer``, ``AVIWriter`` or ``Y4MWriter`` by the suffix; any
    other raises."""
    if _suffix(path) in MP4_SUFFIXES:
        return MP4Writer(path, width, height, fps)
    if _suffix(path) in AVI_SUFFIXES:
        return AVIWriter(path, width, height, fps)
    _check_path(path, Y4M_SUFFIXES + MP4_SUFFIXES + AVI_SUFFIXES)
    return Y4MWriter(path, width, height, fps)


class _Frames:
    """What the readers share: ``read`` in BGR, iteration, the context."""

    width: int
    height: int

    def read_i420(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def read(self) -> Optional[np.ndarray]:
        """The next frame as (H, W, 3) BGR uint8, or None at the end."""
        yuv = self.read_i420()
        return None if yuv is None else i420_to_bgr(yuv, self.height, self.width)

    def __iter__(self) -> Iterator[np.ndarray]:
        while (frame := self.read()) is not None:
            yield frame

    def i420_frames(self) -> Iterator[np.ndarray]:
        """The remaining frames' (H*3/2, W) I420 planes."""
        while (planes := self.read_i420()) is not None:
            yield planes

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Queued(_Frames):
    """Readers whose decoder takes access units and lets out frames,
    several or none a unit and the rest at the end (H.264 reorders): a
    queue of the frames let out, each checked against the stream's size."""

    _pending: Deque[np.ndarray]
    _flushed: bool
    #: the clockwise turn of the frames, in degrees (an MP4 track's
    #: display matrix)
    rotation = 0

    def _coded(self) -> Tuple[int, int]:
        """(width, height) of the frames as decoded, before the turn."""
        return (self.height, self.width) if self.rotation in (90, 270) else \
            (self.width, self.height)

    def _next_access_unit(self) -> Optional[bytes]:
        raise NotImplementedError

    def _decode(self, au: bytes) -> List[np.ndarray]:
        raise NotImplementedError

    def _flush(self) -> List[np.ndarray]:
        raise NotImplementedError

    def _queue(self, frames: List[np.ndarray]) -> None:
        w, h = self._coded()
        for f in frames:
            if f.shape != (h * 3 // 2, w):
                raise ValueError(f"a frame of {f.shape[1]}x{f.shape[0] * 2 // 3} in a stream of "
                                 f"{w}x{h}: a change of size is not supported")
        self._pending.extend(frames)

    def _h264_start(self, path: str) -> None:
        """The size of the first SPS: access units are decoded (their
        frames kept) until one is active."""
        frames: List[np.ndarray] = []
        while not self._decoder.width:
            au = self._next_access_unit()
            if au is None:
                raise ValueError(f"{path}: an H.264 stream without a sequence parameter set")
            frames += self._decoder.decode(au)
        self.width, self.height = self._decoder.width, self._decoder.height
        self._queue(frames)

    def read_planes(self):
        """The next frame's planes as the decoder gives them, or None at the
        end: (H*3/2, W) I420 planes (Motion JPEG: ``render/mjpeg``'s)."""
        while not self._pending and not self._flushed:
            au = self._next_access_unit()
            if au is None:
                self._flushed = True
                self._queue(self._flush())
            else:
                self._queue(self._decode(au))
        return self._pending.popleft() if self._pending else None

    def read_i420(self) -> Optional[np.ndarray]:
        """The next frame's (H*3/2, W) I420 planes, or None at the end."""
        return self.read_planes()

    def stats(self) -> dict:
        """The decoder's counts of the stream's tools (``render/mpeg4.STATS``,
        ``render/h264.STATS`` or ``render/mjpeg.STATS``)."""
        return self._decoder.stats()


class _SampleReader(_Queued):
    """Frames of a container's video samples (``_demux``: ``len`` and
    ``read(i)``) through the decoder of their codec: ``mp4v`` (MPEG-4 Part
    2), ``mjpeg`` (Motion JPEG) or H.264 (``avc1``, ``avc3``, ``h264``)."""

    _demux = None

    def _start(self, path: str, codec: str, config: Optional[bytes], fps: float,
               container_size: Tuple[int, int], delay: int = 0, tag: bytes = b"") -> None:
        self.codec, self.fps = codec, fps
        self._next = 0
        self._pending, self._flushed = deque(), False
        if codec == "mp4v":
            self._decoder = mpeg4.Decoder(config, tag)
            self.width, self.height = self._decoder.width, self._decoder.height
        elif codec == "mjpeg":
            # the size is the first frame's (FFmpeg's, from its SOF), the
            # container's when there is none
            self._decoder = mjpeg.Decoder(container_size[1])
            self.width = self.height = 0
            first = self._next_access_unit()
            if first is None:
                self.width, self.height = container_size
            else:
                self._queue(self._decode(first))
            return
        else:
            samples = (self._demux.read(i) for i in range(len(self._demux)))
            delay = h264.probe_delay(samples, config, delay)
            self._decoder = h264.Decoder(config, delay)
            self._h264_start(path)
        if self.width % 2 or self.height % 2:
            raise ValueError(f"{path}: 4:2:0 frames need even sides, got "
                             f"{self.width}x{self.height}")

    def __len__(self) -> int:
        """The stream's samples.  An H.264 stream gives as many frames
        unless its reorder delay grows past the one the probe found; then
        FFmpeg, and the reader with it, drop the pictures that come too
        late (``stats()["dropped_pictures"]``)."""
        return len(self._demux)

    def _next_access_unit(self) -> Optional[bytes]:
        if self._next >= len(self._demux):
            return None
        self._next += 1
        return self._demux.read(self._next - 1)

    def _queue(self, frames) -> None:
        if self.codec != "mjpeg":
            super()._queue(frames)
            return
        if not frames:
            return
        d = self._decoder
        if not self.width:
            self.width, self.height = d.width, d.height
        if (d.width, d.height) != self._coded():
            raise ValueError(f"a frame of {d.width}x{d.height} in a stream of "
                             "{}x{}: a change of size is not supported".format(*self._coded()))
        self._pending.extend(frames)

    def _decode(self, sample: bytes) -> list:
        if self.codec == "mjpeg":
            try:
                return [self._decoder.decode(sample)]
            except ValueError:
                # an AVI's partial last chunk that does not reach its scan
                # fails in FFmpeg too, and gives no frame
                if getattr(self._demux, "partial", False) and self._next == len(self._demux):
                    return []
                raise
        if self.codec == "mp4v":
            w, h = self._coded()
            return [f.reshape(h * 3 // 2, w) for f in self._decoder.decode(sample)]
        try:
            return self._decoder.decode(sample)
        except ValueError:
            # an MP4's H.264 sample cut by the end of the file, a NAL unit
            # running past it: FFmpeg refuses the whole sample, and cv2's
            # frame-threaded decode loses the frame before it as well
            if self._cut_h264_mp4() and self._next == len(self._demux):
                self._lose_last = True
                return []
            raise

    def _cut_h264_mp4(self) -> bool:
        """An H.264 MP4 whose last sample is cut by the end of the file."""
        return (self.codec not in ("mp4v", "mjpeg") and isinstance(self._demux, mp4.Demuxer)
                and self._demux.partial)

    _lose_last = False

    def read_planes(self):
        # an H.264 MP4 cut in its last sample: the frame before it waits
        # until that sample has been tried
        if len(self._pending) == 1 and not self._flushed and self._cut_h264_mp4():
            while not self._flushed and len(self._pending) < 2:
                au = self._next_access_unit()
                if au is None:
                    self._flushed = True
                    self._queue(self._flush())
                else:
                    self._queue(self._decode(au))
        return super().read_planes()

    def _flush(self) -> List[np.ndarray]:
        if self.codec == "mjpeg":
            return []
        frames = self._decoder.flush()
        if self._lose_last:
            self._lose_last = False
            if frames:
                frames = frames[:-1]
            elif self._pending:
                self._pending.pop()
        if self.codec != "mp4v":
            return frames
        w, h = self._coded()
        return [f.reshape(h * 3 // 2, w) for f in frames]

    def read(self) -> Optional[np.ndarray]:
        if self.codec != "mjpeg":
            return super().read()
        # a Motion JPEG sample gives one frame as it is decoded, so the
        # frame taken is the decoder's last
        if _Queued.read_planes(self) is None:
            return None
        return turn(self._decoder.bgr(), self.rotation)

    def read_i420(self) -> Optional[np.ndarray]:
        if self.codec == "mjpeg":
            raise ValueError(
                "Motion JPEG frames are full-range yuvj planes (4:2:2 as often as 4:2:0), not "
                "I420: read() gives them in BGR, read_planes() as decoded")
        return super().read_i420()

    def close(self) -> None:
        if self._demux is not None:
            self._demux.close()
        if self._decoder is not None:
            self._decoder.close()


def turn(img: np.ndarray, rotation: int) -> np.ndarray:
    """``img`` turned clockwise by 0, 90, 180 or 270 degrees (``cv::rotate``)."""
    if not rotation:
        return img
    return np.ascontiguousarray(np.rot90(img, {90: -1, 180: 2, 270: 1}[rotation]))


def turn_i420(yuv: np.ndarray, width: int, height: int, rotation: int) -> np.ndarray:
    """The (H*3/2, W) I420 planes of a ``width`` x ``height`` frame, each
    plane turned clockwise by ``rotation``: the I420 of the turned frame
    (the chroma of a 2x2 block stays that block's)."""
    if not rotation:
        return yuv
    y = turn(yuv[:height], rotation)
    u, v = (turn(c, rotation) for c in yuv[height:].reshape(2, height // 2, width // 2))
    return np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(-1, y.shape[1])


class MP4Reader(_SampleReader):
    """Frames of the first video track of an MP4 (``mp4v``, ``avc1``,
    ``avc3``, or Motion JPEG: ``codec`` ``"mjpeg"``) as BGR uint8 arrays,
    in display order; ``width``, ``height`` and ``fps`` from the track (an
    H.264 track's size from its SPS, a Motion JPEG one's from its first
    frame).  A display matrix that turns the picture by 90, 180 or 270
    degrees turns the frames, and ``width`` and ``height`` are the turned
    frame's, as cv2 reads the file (``CAP_PROP_ORIENTATION_AUTO``, on by
    default): ``rotation``."""

    def __init__(self, path: str):
        _check_path(path, MP4_SUFFIXES)
        self._demux = mp4.Demuxer(path)
        self._decoder = None
        try:
            track = self._demux.track
            self._start(path, track.codec, track.dsi, track.fps, (track.width, track.height),
                        track.video_delay, b"mp4v")
            self.rotation = track.rotation
            if self.rotation in (90, 270):
                self.width, self.height = self.height, self.width
        except Exception:
            self.close()
            raise

    def read_planes(self):
        """The next frame's I420 planes, turned as the frames are; a Motion
        JPEG stream's decoded planes when the track does not turn them."""
        if self.rotation and self.codec == "mjpeg":
            raise ValueError(
                f"the track's display matrix turns its frames by {self.rotation} degrees: "
                f"read() gives them turned in BGR; Motion JPEG planes (4:2:2 as often as "
                f"4:2:0) are not turned")
        planes = super().read_planes()
        if planes is None or not self.rotation:
            return planes
        w, h = self._coded()
        return turn_i420(planes, w, h, self.rotation)


class AVIReader(_SampleReader):
    """Frames of the first video stream of an AVI (``mp4v``/``XVID``/
    ``DIVX``-family, H.264 or Motion JPEG; ``render/avi.CODECS``) as BGR
    uint8 arrays, in display order, as cv2 reads them; ``width``,
    ``height`` and ``fps`` (``dwRate / dwScale``) from the stream."""

    def __init__(self, path: str):
        _check_path(path, AVI_SUFFIXES)
        self._demux = avi.Demuxer(path)
        self._decoder = None
        try:
            stream = self._demux.stream
            config = None
            if stream.codec == "mp4v":
                if not len(self._demux):
                    raise ValueError(f"{path}: an MPEG-4 Part 2 stream without frames")
                config = avi.mpeg4_config(stream.extradata, self._demux.read(0))
            self._start(path, stream.codec, config, stream.fps, (stream.width, stream.height),
                        tag=stream.tag.encode("latin-1"))
        except Exception:
            self.close()
            raise


def _file_nals(f) -> Iterator[bytes]:
    """The NAL units of an Annex B file, read ``CHUNK`` bytes at a time:
    each complete once the next start code (or the end of the file) is
    read."""
    buf, pos, eof = b"", 0, False
    while True:
        start = buf.find(b"\x00\x00\x01", pos)
        if start >= 0:
            end = buf.find(b"\x00\x00\x01", start + 3)
            if end >= 0 or eof:
                stop = end if end >= 0 else len(buf)
                nal = buf[start + 3:stop].rstrip(b"\x00")
                pos = stop
                if nal:
                    yield nal
                continue
        elif eof:
            return
        # keep the unfinished NAL unit (or two bytes of a split start code)
        keep = start if start >= 0 else max(pos, len(buf) - 2)
        chunk = f.read(CHUNK)
        eof = not chunk
        buf, pos = buf[keep:] + chunk, 0


def _file_access_units(f) -> Iterator[bytes]:
    return (h264.annexb(au) for au in h264.access_units(_file_nals(f)))


class AnnexBReader(_Queued):
    """Frames of a raw H.264 Annex B stream (``.h264``, ``.264``) as BGR
    uint8 arrays, in display order; ``width`` and ``height`` from its SPS,
    ``fps`` from the SPS's VUI timing or ``H264_FPS``."""

    def __init__(self, path: str):
        _check_path(path, H264_SUFFIXES)
        self._f = open(path, "rb")
        self._aus = _file_access_units(self._f)
        self._decoder = None
        self._pending, self._flushed = deque(), False
        try:
            with open(path, "rb") as probe:
                delay = h264.probe_delay(_file_access_units(probe))
            self._decoder = h264.Decoder(None, delay)
            self._h264_start(path)
            if self.width % 2 or self.height % 2:
                raise ValueError(f"{path}: 4:2:0 frames need even sides, got "
                                 f"{self.width}x{self.height}")
            self.fps = self._decoder.fps or H264_FPS
        except Exception:
            self.close()
            raise

    def _next_access_unit(self) -> Optional[bytes]:
        return next(self._aus, None)

    def _decode(self, au: bytes) -> List[np.ndarray]:
        return self._decoder.decode(au)

    def _flush(self) -> List[np.ndarray]:
        return self._decoder.flush()

    def close(self) -> None:
        self._f.close()
        if self._decoder is not None:
            self._decoder.close()


class _MPEG4Writer:
    """Writes BGR uint8 frames of one size as MPEG-4 Part 2 video (``mp4v``,
    the fourcc of the JAX package's writer) at ``fps`` into the container
    of the subclass.  ``write`` and ``write_i420`` return the frame's
    reconstructed I420 planes: what a reader of the file decodes, to the
    bit."""

    suffixes: tuple = ()

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        _check_path(path, self.suffixes)
        if width % 2 or height % 2:
            raise ValueError(f"4:2:0 needs even sides, got {width}x{height}")
        self.width, self.height = width, height
        timescale, delta = mp4.rate(fps)
        self._encoder = mpeg4.Encoder(width, height, timescale, delta)
        self._mux = self._muxer(path, fps, timescale, delta)

    def _muxer(self, path: str, fps: float, timescale: int, delta: int):
        raise NotImplementedError

    def _add(self, vop: bytes, key: bool) -> None:
        self._mux.add(vop, key)

    def write(self, frame: np.ndarray) -> np.ndarray:
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"expected a ({self.height}, {self.width}, 3) frame, got "
                             f"{frame.shape}")
        return self.write_i420(bgr_to_i420(frame))

    def write_i420(self, yuv: np.ndarray) -> np.ndarray:
        if yuv.shape != (self.height * 3 // 2, self.width):
            raise ValueError(f"expected ({self.height * 3 // 2}, {self.width}) I420 planes, got "
                             f"{yuv.shape}")
        vop, key, recon = self._encoder.encode(yuv)
        self._add(vop, key)
        return recon.reshape(yuv.shape)

    def close(self) -> None:
        self._mux.close()
        self._encoder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MP4Writer(_MPEG4Writer):
    """An MP4 of ``mp4v`` video, the VOS/VOL headers in the ``esds``."""

    suffixes = MP4_SUFFIXES

    def _muxer(self, path, fps, timescale, delta):
        return mp4.Muxer(path, self.width, self.height, self._encoder.header(), timescale,
                         delta)


class AVIWriter(_MPEG4Writer):
    """An AVI of ``mp4v`` video in FFmpeg's layout (``render/avi.Muxer``);
    AVI has no ``esds``, so the VOS/VOL headers go in band before each
    I-VOP, as FFmpeg's encoder writes them for an AVI."""

    suffixes = AVI_SUFFIXES

    def _muxer(self, path, fps, timescale, delta):
        return avi.Muxer(path, self.width, self.height, b"mp4v", fps)

    def _add(self, vop: bytes, key: bool) -> None:
        self._mux.add(self._encoder.header() + vop if key else vop, key)


class Y4MReader(_Frames):
    """Frames of a 4:2:0 ``.y4m`` file as BGR uint8 arrays, in order;
    ``width``, ``height`` and ``fps`` from the header."""

    def __init__(self, path: str):
        _check_path(path, Y4M_SUFFIXES)
        self._f = open(path, "rb")
        try:
            header = self._f.readline()
            if not header.startswith(MAGIC) or not header.endswith(b"\n"):
                raise ValueError(f"{path}: not a YUV4MPEG2 stream")
            tags = {t[:1]: t[1:] for t in header[len(MAGIC):].decode("ascii").split()}
            self.width, self.height = int(tags["W"]), int(tags["H"])
            chroma = tags.get("C", "420jpeg")
            if chroma not in CHROMA_420:
                raise ValueError(f"{path}: chroma C{chroma} is not 4:2:0 "
                                 f"(the reader takes C{', C'.join(CHROMA_420)})")
            if self.width % 2 or self.height % 2:
                raise ValueError(f"{path}: 4:2:0 needs even sides, got "
                                 f"{self.width}x{self.height}")
            self.fps = float(Fraction(tags.get("F", "30:1").replace(":", "/")))
        except Exception:
            self._f.close()
            raise
        self.frame_bytes = self.width * self.height * 3 // 2

    def read_i420(self) -> Optional[np.ndarray]:
        """The next frame's (H*3/2, W) I420 planes, or None at the end."""
        line = self._f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"expected a FRAME header, got {line[:16]!r}")
        data = self._f.read(self.frame_bytes)
        if len(data) != self.frame_bytes:
            raise ValueError(f"truncated frame: {len(data)} of {self.frame_bytes} bytes")
        return np.frombuffer(data, np.uint8).reshape(self.height * 3 // 2, self.width)

    def close(self) -> None:
        self._f.close()


class Y4MWriter:
    """Writes BGR uint8 frames of one size to a 4:2:0 ``.y4m`` file."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        _check_path(path, Y4M_SUFFIXES)
        if width % 2 or height % 2:
            raise ValueError(f"4:2:0 needs even sides, got {width}x{height}")
        self.width, self.height = width, height
        rate = Fraction(fps).limit_denominator(1001)
        self._f = open(path, "wb")
        self._f.write(b"%s W%d H%d F%d:%d Ip A1:1 C420jpeg\n"
                      % (MAGIC, width, height, rate.numerator, rate.denominator))

    def write(self, frame: np.ndarray) -> None:
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"expected a ({self.height}, {self.width}, 3) frame, got "
                             f"{frame.shape}")
        self.write_i420(bgr_to_i420(frame))

    def write_i420(self, yuv: np.ndarray) -> None:
        if yuv.shape != (self.height * 3 // 2, self.width):
            raise ValueError(f"expected ({self.height * 3 // 2}, {self.width}) I420 planes, got "
                             f"{yuv.shape}")
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(yuv, np.uint8).tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
