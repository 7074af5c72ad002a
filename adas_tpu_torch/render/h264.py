"""ctypes binding of ``native/h264.cpp``: the H.264 decoder of the demo's
video input (``render/video.py``), for I, P and B pictures of progressive
8-bit 4:2:0 streams (Constrained Baseline, Main and High profiles; CAVLC
and CABAC).

``Decoder(avcc, delay)`` takes an MP4 track's ``avcC`` record (its SPS and
PPS and the NAL length size), or None for an Annex B byte stream.
``decode(access_unit)`` feeds one sample (length-prefixed NAL units) or a
piece of an Annex B stream and gives the list of frames now ready for
output, in display order: each a (height * 3 / 2, width) uint8 array of
I420 planes, cropped.  ``flush()`` at the end gives the rest.  ``stats()``
counts the tools the stream used (``STATS``).  ``width``, ``height`` and
``fps`` are those of the active SPS (0 before one is active).

Output follows FFmpeg's, which cv2 runs: frames leave in POC order behind
a reorder delay that starts at ``delay`` (``probe_delay``: what FFmpeg's
stream probe reaches from the container's delay), is at least the VUI's
``max_num_reorder_frames``, and without the VUI's bitstream restriction
grows as pictures arrive out of order; a picture that arrives after a
later one was output is dropped (``stats()["dropped_pictures"]``), as
FFmpeg drops it.

Damaged, cut or lost slices are decoded and concealed as FFmpeg conceals
them (``native/error_resilience.h``), at the end of each ``decode`` call
(a packet), and a gap in frame_num is filled as FFmpeg fills it;
``stats()`` counts ``concealed_mbs``, ``damaged_pictures``,
``damaged_slices``, ``gap_frames`` and the microseconds spent concealing
(``conceal_us``).  A parameter set or slice header FFmpeg cannot read is
skipped as FFmpeg skips it (``skipped_headers``): the parameter set before
it stays, the slice's macroblocks are concealed, a picture without a
readable slice gives no frame.  A stream that starts without an IDR
picture decodes as FFmpeg's does: missing references are gray, and a
picture comes out only from FFmpeg's recovery point on (an IDR picture,
or an I picture its marking heuristic takes; ``unrecovered_pictures``
counts those left out).  SP and SI slices, field pictures and MBAFF, chroma
formats other than 4:2:0, bit depths above 8, slice groups, redundant
pictures, data partitioning, transform bypass, a NAL unit that runs past
its sample and pictures of more than ``MAX_PIXELS`` raise a ``ValueError``
carrying the library's message, which names the tool.  The library is
built with g++ into ``adas_tpu_torch/_build/libh264.so`` on first use
(``native/gxx.py``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..native.gxx import build_library

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                   "h264.cpp")
#: FFmpeg's error concealment, shared with mpeg4.cpp
ER_H = os.path.join(os.path.dirname(SRC), "error_resilience.h")
_LOCK = threading.Lock()
_lib = None

#: the largest picture, in pixels (``kMaxPixels`` of the library)
MAX_PIXELS = 1 << 25
#: the decoder's counters, in the library's order (``Stat`` in h264.cpp)
STATS = ("i_slices", "p_slices", "idr_pictures", "pictures", "cavlc_slices", "cabac_slices",
         "i4x4", "i8x8", "i16x16", "ipcm", "p16x16", "p16x8", "p8x16", "p8x8", "p8x8ref0",
         "pskip", "sub_partitions_below_8x8", "inter_8x8_transform", "weighted_slices",
         "ref_list_modifications", "mmcos", "mmco5", "long_term_marks", "mbs_ref_idx_above_0",
         "scaling_matrix_pictures", "constrained_intra_pictures", "deblocking_off_slices",
         "deblocking_slice_edge_off_slices", "non_reference_pictures", "poc_type_0",
         "poc_type_1", "poc_type_2", "cropped_pictures", "b_slices", "b_direct_16x16", "b16x16",
         "b16x8", "b8x16", "b8x8", "bskip", "b_direct_8x8", "b_sub_partitions_below_8x8",
         "bi_predicted_mbs", "spatial_direct_slices", "temporal_direct_slices",
         "implicit_weight_slices", "explicit_bipred_slices", "ref_list1_modifications",
         "b_mbs_from_long_term", "reference_b_pictures", "direct_4x4_mbs", "dropped_pictures",
         "reorder_delay", "concealed_mbs", "damaged_pictures", "damaged_slices", "gap_frames",
         "conceal_us", "skipped_headers", "unrecovered_pictures")


class Refused(ValueError):
    """A packet FFmpeg's decoder refuses as a whole (an error from its
    decode call): cv2's ``grab`` fails there, and its reading ends.  The
    frames let out before it stand; those the decoder still held are lost."""


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(SRC, "h264", deps=(ER_H,)))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                ip = ctypes.POINTER(ctypes.c_int)
                sigs = {
                    "h264_decoder_new": ([], p), "h264_decoder_free": ([p], None),
                    "h264_decoder_error": ([p], ctypes.c_char_p),
                    "h264_decode": ([p, p, l, i], i), "h264_flush": ([p], i),
                    "h264_set_delay": ([p, i], None), "h264_refused": ([p], i), "h264_last_poc": ([p], i),
                    "h264_size": ([p, ip, ip], None), "h264_fps": ([p], ctypes.c_double),
                    "h264_next_frame": ([p, p, l, ip, ip], i),
                    "h264_next_frame_bytes": ([p], l), "h264_stats": ([p, p, i], i),
                }
                for name, (args, res) in sigs.items():
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def parse_avcc(avcc: bytes) -> Tuple[int, List[bytes]]:
    """(NAL length size, the SPS and PPS NAL units) of an
    AVCDecoderConfigurationRecord."""
    if len(avcc) < 7 or avcc[0] != 1:
        raise ValueError("corrupt MP4: an avcC record of another version or truncated")
    length_size = (avcc[4] & 3) + 1
    if length_size == 3:
        raise ValueError("corrupt MP4: avcC NAL length size of 3 bytes")
    nals, pos = [], 5
    for count_bytes, mask in ((1, 0x1F), (1, 0xFF)):
        if pos + count_bytes > len(avcc):
            raise ValueError("truncated avcC record")
        count = avcc[pos] & mask
        pos += 1
        for _ in range(count):
            if pos + 2 > len(avcc):
                raise ValueError("truncated avcC record")
            n = struct.unpack_from(">H", avcc, pos)[0]
            pos += 2
            if pos + n > len(avcc):
                raise ValueError("truncated avcC record")
            nals.append(avcc[pos:pos + n])
            pos += n
    return length_size, nals


class Decoder:
    """An H.264 stream's decoder: length-prefixed samples after an avcC
    record, or an Annex B byte stream (``avcc`` None).  ``delay`` is the
    reorder delay output starts from (``probe_delay``)."""

    def __init__(self, avcc: Optional[bytes] = None, delay: int = 0):
        lib = _native()
        self._lib, self._d = lib, lib.h264_decoder_new()
        if not self._d:
            raise MemoryError("h264 decoder")
        lib.h264_set_delay(self._d, int(delay))
        self._length_size = 0
        self._ready: List[np.ndarray] = []
        if avcc is not None:
            try:
                self._length_size, nals = parse_avcc(avcc)
            except Exception:
                self.close()
                raise
            for nal in nals:
                self._feed(struct.pack(">I", len(nal)) + nal, 4)

    def _raise(self):
        raise ValueError(self._lib.h264_decoder_error(self._d).decode())

    def _feed(self, data: bytes, length_size: int) -> None:
        if not self._d:
            raise ValueError("the H.264 decoder is closed")
        if self._lib.h264_decode(self._d, data, len(data), length_size) < 0:
            self._raise()

    def _take(self) -> List[np.ndarray]:
        frames = []
        w, h = ctypes.c_int(), ctypes.c_int()
        while (n := self._lib.h264_next_frame_bytes(self._d)) > 0:
            buf = np.empty(n, np.uint8)
            if self._lib.h264_next_frame(self._d, buf.ctypes.data, n, ctypes.byref(w),
                                         ctypes.byref(h)):
                raise ValueError("the H.264 decoder lost a frame")
            frames.append(buf.reshape(h.value * 3 // 2, w.value))
        return frames

    def decode(self, data: bytes) -> List[np.ndarray]:
        """Feeds an access unit (or any run of NAL units); the frames now
        ready for output, in display order."""
        self._feed(data, self._length_size)
        if self._lib.h264_refused(self._d):
            raise Refused("corrupt H.264 data: no slice of the packet could be read (FFmpeg "
                          "refuses the packet, and cv2 stops reading there)")
        return self._take()

    def flush(self) -> List[np.ndarray]:
        """The frames still held for reordering, at the end of the stream."""
        if self._lib.h264_flush(self._d) < 0:
            self._raise()
        return self._take()

    @property
    def width(self) -> int:
        return self._size()[0]

    @property
    def height(self) -> int:
        return self._size()[1]

    def _size(self) -> Tuple[int, int]:
        w, h = ctypes.c_int(), ctypes.c_int()
        self._lib.h264_size(self._d, ctypes.byref(w), ctypes.byref(h))
        return w.value, h.value

    @property
    def last_poc(self) -> int:
        """The picture order count of the last picture begun."""
        return int(self._lib.h264_last_poc(self._d))

    @property
    def fps(self) -> float:
        """The frame rate of the SPS's VUI timing, 0.0 without one."""
        return float(self._lib.h264_fps(self._d))

    def stats(self) -> Dict[str, int]:
        out = np.zeros(len(STATS), np.int64)
        self._lib.h264_stats(self._d, out.ctypes.data, len(STATS))
        return dict(zip(STATS, out.tolist()))

    def close(self) -> None:
        if self._d:
            self._lib.h264_decoder_free(self._d)
            self._d = None

    def __del__(self):
        self.close()


def _probe_frames(delay: int) -> int:
    """Frames FFmpeg's stream probe decodes before it takes a reorder delay
    as found (libavformat's ``has_decode_delay_been_guessed``)."""
    return 7 if delay < 3 else 18 if delay < 4 else 20


def probe_delay(access_units: Iterable[bytes], avcc: Optional[bytes] = None,
                delay: int = 0) -> int:
    """The reorder delay cv2's decoder starts from: what FFmpeg's stream
    probe (``avformat_find_stream_info``) reaches decoding the first access
    units from ``delay`` (the container's: 0 for a raw stream, the depth of
    an MP4's ``ctts``) until 7 frames are out (18 at a delay of 3, 20
    above).  An error
    ends the probe; the decode proper raises it."""
    d = Decoder(avcc, delay)
    try:
        out = 0
        for au in access_units:
            out += len(d.decode(au))
            if out >= _probe_frames(d.stats()["reorder_delay"]):
                break
    except ValueError:
        pass
    found = d.stats()["reorder_delay"]
    d.close()
    return found


# ------------------------------------------------------------------ Annex B

def nal_units(data: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream (3- and 4-byte start codes,
    trailing zero bytes dropped)."""
    out, pos = [], data.find(b"\x00\x00\x01")
    while pos >= 0:
        start = pos + 3
        nxt = data.find(b"\x00\x00\x01", start)
        end = len(data) if nxt < 0 else nxt
        nal = data[start:end].rstrip(b"\x00")
        if nal:
            out.append(nal)
        pos = nxt
    return out


def access_units(nals: Iterable[bytes]) -> Iterator[List[bytes]]:
    """NAL units grouped into access units, as they come: a new one starts
    at a slice with first_mb_in_slice 0 (its first bit after the header is
    1), and at an SPS, PPS, AUD or SEI that follows a slice."""
    cur: List[bytes] = []
    seen_slice = False
    for nal in nals:
        kind = nal[0] & 0x1F
        is_slice = kind in (1, 5)
        if seen_slice and ((is_slice and len(nal) > 1 and nal[1] & 0x80) or kind in (6, 7, 8, 9)):
            yield cur
            cur, seen_slice = [], False
        cur.append(nal)
        seen_slice |= is_slice
    if cur:
        yield cur


def annexb(nals: List[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


__all__ = ["Decoder", "Refused", "STATS", "MAX_PIXELS", "parse_avcc", "nal_units", "access_units", "annexb",
           "probe_delay"]
