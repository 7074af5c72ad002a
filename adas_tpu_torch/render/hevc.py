"""ctypes binding of ``native/hevc.cpp``: the H.265 / HEVC decoder of the
demo's video input (``render/video.py``), for I, P and B pictures of 8-bit
4:2:0 Main-profile streams, with explicit weighted prediction.

``Decoder(hvcc)`` takes an MP4 track's ``hvcC`` record (its parameter sets
and the NAL length size), or None for an Annex B byte stream.
``decode(access_unit)`` feeds one sample (length-prefixed NAL units) or a
piece of an Annex B stream and gives the list of frames now ready for
output, in display order: each a (height * 3 / 2, width) uint8 array of
I420 planes, cropped to the conformance window.  ``flush()`` at the end
gives the rest.  ``stats()`` counts the tools the stream used
(``STATS``).  ``width``, ``height`` and ``fps`` are those of the active SPS
(0 before one is active); ``last_poc`` that of the last picture started.

Output follows FFmpeg's, which cv2 runs: a picture comes out when more
pictures wait than ``sps_max_num_reorder_pics`` or the DPB holds more than
``sps_max_dec_pic_buffering``, lowest POC first; pictures with
``pic_output_flag`` 0 never come out; RASL pictures of a CRA picture that
starts the stream are skipped; a stream that does not start with an IRAP
picture decodes from gray missing references.  Long-term reference
pictures, tiles, dependent slice segments,
``cu_transquant_bypass``, bit depths above 8 and chroma other than 4:2:0
(Main 10 and the range extensions), full-range video, field-coded video,
layers above 0 and pictures of more than ``MAX_PIXELS`` raise a
``ValueError`` carrying the library's message, which names the tool;
damaged data decodes or raises a ``ValueError`` (FFmpeg's hevc decoder
conceals nothing).  The library is built with g++ into
``adas_tpu_torch/_build/libhevc.so`` on first use (``native/gxx.py``); a
failed build raises.
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
                   "hevc.cpp")
_LOCK = threading.Lock()
_lib = None

#: the largest picture, in pixels (``kMaxPixels`` of the library)
MAX_PIXELS = 1 << 25
#: the decoder's counters, in the library's order (``Stat`` in hevc.cpp)
STATS = ("pictures", "idr_pictures", "cra_pictures", "other_irap_pictures", "i_slices", "p_slices",
         "slices_after_the_first", "ctb16_pictures", "ctb32_pictures", "ctb64_pictures",
         "split_cus", "skip_cus", "merge_pus", "amvp_pus", "amp_cus", "inter_nxn_cus",
         "part_2nxn_cus", "part_nx2n_cus", "intra_nxn_cus", "intra_angular", "intra_planar",
         "intra_dc", "chroma_dm", "pcm_cus", "tu_splits", "tu4", "tu32", "dst_blocks",
         "transform_skip_blocks", "sign_hidden_groups", "qp_deltas", "scaling_list_blocks",
         "chroma_qp_offset_slices", "constrained_intra_pictures", "strong_smoothing",
         "tmvp_candidates", "scaled_mvs", "multi_ref_pus", "parallel_merge_pus",
         "deblocking_off_slices", "deblocked_edges", "sao_band", "sao_edge", "sao_merges",
         "wpp_rows", "cabac_init_slices", "cropped_pictures", "inter_rps_pictures",
         "rasl_skipped", "missing_refs", "not_output", "reordered_outputs", "list_modifications",
         "pcm_unfiltered", "slices_not_across", "dropped_pictures", "constrained_intra_blocks",
         "b_slices", "bi_pus", "l1_pus", "combined_bi_merges", "tmvp_l1", "collocated_from_l1_slices",
         "mvd_l1_zero_pus", "list_modifications_l1", "bi_merges_to_l0", "weighted_pus",
         "weighted_slices", "zero_merges_b")


def _native():
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build_library(SRC, "hevc"))
                p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
                ip = ctypes.POINTER(ctypes.c_int)
                sigs = {
                    "hevc_decoder_new": ([], p), "hevc_decoder_free": ([p], None),
                    "hevc_decoder_error": ([p], ctypes.c_char_p),
                    "hevc_decode": ([p, p, l, i], i), "hevc_flush": ([p], i),
                    "hevc_size": ([p, ip, ip], None), "hevc_fps": ([p], ctypes.c_double),
                    "hevc_next_frame": ([p, p, l, ip, ip], i),
                    "hevc_next_frame_bytes": ([p], l), "hevc_stats": ([p, p, i], i),
                    "hevc_last_poc": ([p], i),
                }
                for name, (args, res) in sigs.items():
                    f = getattr(lib, name)
                    f.argtypes, f.restype = args, res
                _lib = lib
    return _lib


def parse_hvcc(hvcc: bytes) -> Tuple[int, List[bytes]]:
    """(NAL length size, the parameter set NAL units) of an
    HEVCDecoderConfigurationRecord."""
    if len(hvcc) < 23 or hvcc[0] != 1:
        raise ValueError("corrupt MP4: an hvcC record of another version or truncated")
    length_size = (hvcc[21] & 3) + 1
    if length_size == 3:
        raise ValueError("corrupt MP4: hvcC NAL length size of 3 bytes")
    nals, pos = [], 23
    for _ in range(hvcc[22]):
        if pos + 3 > len(hvcc):
            raise ValueError("truncated hvcC record")
        count = struct.unpack_from(">H", hvcc, pos + 1)[0]
        pos += 3
        for _ in range(count):
            if pos + 2 > len(hvcc):
                raise ValueError("truncated hvcC record")
            n = struct.unpack_from(">H", hvcc, pos)[0]
            pos += 2
            if pos + n > len(hvcc):
                raise ValueError("truncated hvcC record")
            nals.append(hvcc[pos:pos + n])
            pos += n
    return length_size, nals


class Decoder:
    """An H.265 stream's decoder: length-prefixed samples after an hvcC
    record, or an Annex B byte stream (``hvcc`` None)."""

    def __init__(self, hvcc: Optional[bytes] = None):
        lib = _native()
        self._lib, self._d = lib, lib.hevc_decoder_new()
        if not self._d:
            raise MemoryError("hevc decoder")
        self._length_size = 0
        if hvcc is not None:
            try:
                self._length_size, nals = parse_hvcc(hvcc)
            except Exception:
                self.close()
                raise
            self._feed(b"".join(struct.pack(">I", len(n)) + n for n in nals), 4)

    def _raise(self):
        raise ValueError(self._lib.hevc_decoder_error(self._d).decode())

    def _feed(self, data: bytes, length_size: int) -> None:
        if not self._d:
            raise ValueError("the H.265 decoder is closed")
        if self._lib.hevc_decode(self._d, data, len(data), length_size) < 0:
            self._raise()

    def _take(self) -> List[np.ndarray]:
        frames = []
        w, h = ctypes.c_int(), ctypes.c_int()
        while (n := self._lib.hevc_next_frame_bytes(self._d)) > 0:
            buf = np.empty(n, np.uint8)
            if self._lib.hevc_next_frame(self._d, buf.ctypes.data, n, ctypes.byref(w),
                                         ctypes.byref(h)):
                raise ValueError("the H.265 decoder lost a frame")
            frames.append(buf.reshape(h.value * 3 // 2, w.value))
        return frames

    def decode(self, data: bytes) -> List[np.ndarray]:
        """Feeds an access unit (or any run of NAL units); the frames now
        ready for output, in display order."""
        self._feed(data, self._length_size)
        return self._take()

    def flush(self) -> List[np.ndarray]:
        """The frames still held for reordering, at the end of the stream."""
        if self._lib.hevc_flush(self._d) < 0:
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
        self._lib.hevc_size(self._d, ctypes.byref(w), ctypes.byref(h))
        return w.value, h.value

    @property
    def last_poc(self) -> int:
        """The POC of the last picture whose decode started."""
        return int(self._lib.hevc_last_poc(self._d))

    @property
    def fps(self) -> float:
        """The frame rate of the SPS's VUI timing, 0.0 without one."""
        return float(self._lib.hevc_fps(self._d))

    def stats(self) -> Dict[str, int]:
        out = np.zeros(len(STATS), np.int64)
        self._lib.hevc_stats(self._d, out.ctypes.data, len(STATS))
        return dict(zip(STATS, out.tolist()))

    def close(self) -> None:
        if self._d:
            self._lib.hevc_decoder_free(self._d)
            self._d = None

    def __del__(self):
        self.close()


# ------------------------------------------------------------------ Annex B

def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


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
    at a slice with first_slice_segment_in_pic_flag 1, and at a VPS, SPS,
    PPS, AUD or prefix SEI that follows a slice."""
    cur: List[bytes] = []
    seen_slice = False
    for nal in nals:
        kind = nal_type(nal)
        is_slice = kind < 32
        if seen_slice and ((is_slice and len(nal) > 2 and nal[2] & 0x80) or kind in (32, 33, 34, 35, 39)):
            yield cur
            cur, seen_slice = [], False
        cur.append(nal)
        seen_slice |= is_slice
    if cur:
        yield cur


def annexb(nals: List[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


__all__ = ["Decoder", "STATS", "MAX_PIXELS", "parse_hvcc", "nal_units", "access_units", "annexb",
           "nal_type"]
