"""Video I/O without cv2: YUV4MPEG2 (``.y4m``) 4:2:0 streams.

The JAX package reads and writes mp4 through ``cv2.VideoCapture`` /
``cv2.VideoWriter``; the card's host has neither cv2 nor a codec, and a
Y4M file is raw I420 frames behind a text header, which any encoder
reads and writes (``ffmpeg -i in.mp4 -pix_fmt yuv420p in.y4m``, and
``ffmpeg -i out.y4m out.mp4`` back).

The writer encodes each BGR frame with ``ops/preprocess.bgr_to_i420``
(``cv2.cvtColor(COLOR_BGR2YUV_I420)`` to the bit) under a ``C420jpeg``
header; the reader decodes with ``native/draw.i420_to_bgr``
(``cv2.cvtColor(COLOR_YUV2BGR_I420)`` to the bit) and takes the ``C420``,
``C420jpeg``, ``C420mpeg2`` and ``C420paldv`` chroma tags (all decoded
alike, nearest chroma upsampling as cv2's) or none, and the ``F`` rate.
Frame sides must be even.
"""
from __future__ import annotations

import os
from fractions import Fraction
from typing import Iterator, Optional

import numpy as np

from ..native.draw import i420_to_bgr
from ..ops.preprocess import bgr_to_i420

MAGIC = b"YUV4MPEG2"
CHROMA_420 = ("420", "420jpeg", "420mpeg2", "420paldv")


def _check_path(path: str) -> None:
    if os.path.splitext(path)[1].lower() != ".y4m":
        raise ValueError(
            f"{path}: the port reads and writes YUV4MPEG2 (.y4m) video only, having no codec; "
            f"convert with e.g. `ffmpeg -i {path} -pix_fmt yuv420p input.y4m` "
            f"(and an output back with `ffmpeg -i output.y4m output.mp4`)"
        )


class Y4MReader:
    """Frames of a 4:2:0 ``.y4m`` file as BGR uint8 arrays, in order;
    ``width``, ``height`` and ``fps`` from the header."""

    def __init__(self, path: str):
        _check_path(path)
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

    def read(self) -> Optional[np.ndarray]:
        """The next frame as (H, W, 3) BGR uint8, or None at the end."""
        yuv = self.read_i420()
        return None if yuv is None else i420_to_bgr(yuv, self.height, self.width)

    def __iter__(self) -> Iterator[np.ndarray]:
        while (frame := self.read()) is not None:
            yield frame

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    """Writes BGR uint8 frames of one size to a 4:2:0 ``.y4m`` file."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        _check_path(path)
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
