"""Standalone lane-detection demos, no tracker or analytics (port of
``adas_tpu/pipeline/lane_demo.py``): run just the lane detector on an
image or a video and draw the points and the ego-lane area through the
facade's ``AutoDrawLanes``.

Images are read and written by ``render/image.py`` (PNG, BMP, JPEG in,
turned by their EXIF Orientation as cv2 turns them; JPEG, PNG, BMP out)
and video by ``render/video.py`` (MP4 or AVI with MPEG-4
Part 2, ``mp4v``, as the JAX package's cv2 writes them, or YUV4MPEG2;
H.264, H.265 and Motion JPEG in MP4 or AVI, and raw H.264 and H.265, read
too), as the
port's ``pipeline/app.py`` serves it.  ``display=True`` is not planned:
the card's host has no window system.

CLI::

    python -m adas_tpu_torch.pipeline.lane_demo -i road.png -o out.png [--device cuda]
    python -m adas_tpu_torch.pipeline.lane_demo -i drive.mp4 -o out.mp4 [--max-frames N]
    python -m adas_tpu_torch.pipeline.lane_demo -i dashcam.avi -o out.avi
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from ..render.image import IMAGE_SUFFIXES, imread, imwrite
from ..render.video import open_reader, open_writer, output_fps
from ..utils.types import LaneModelType
from .app import _no_display


def make_lane_detector(config: dict, logger=None):
    """The facade ``config["model_type"]`` names, built from ``config``
    (``lane_demo.py:19``; its ``device`` too, default ``cuda``)."""
    if "UFLDV2" in config["model_type"].name:
        return UltrafastLaneDetectorV2(logger=logger, **config)
    return UltrafastLaneDetector(logger=logger, **config)


def _config(config: Optional[dict], device) -> dict:
    config = dict(config or {"model_path": None, "model_type": LaneModelType.UFLDV2_CULANE})
    config.setdefault("device", device)
    return config


def run_lane_image(
    image_path: str,
    output_path: Optional[str] = None,
    config: Optional[dict] = None,
    device="cuda",
) -> np.ndarray:
    """Detect and draw lanes on one image; returns the annotated array
    (``lane_demo.py:24``), written to ``output_path`` (``.jpg``, ``.png`` or
    ``.bmp``, as ``cv2.imwrite`` writes them) when given."""
    img = imread(image_path)
    if img is None:
        raise FileNotFoundError(image_path)
    out = make_lane_detector(_config(config, device)).AutoDrawLanes(img)
    if output_path:
        imwrite(output_path, out)
    return out


def run_lane_video(
    video_path: str,
    output_path: Optional[str] = None,
    config: Optional[dict] = None,
    display: bool = False,
    max_frames: Optional[int] = None,
    device="cuda",
) -> int:
    """Lane-only loop over a video (``.mp4``/``.mov`` or ``.avi`` with
    ``mp4v``, H.264, H.265 or Motion JPEG, a raw ``.h264`` or
    ``.h265``/``.265``/``.hevc``, or ``.y4m``), the
    annotated frames written to ``output_path``: an ``.mp4`` or ``.avi`` at
    30 fps, as the reference writes them, or a ``.y4m`` at the input's
    rate; returns the
    processed frame count (``lane_demo.py:47``).  The reference skips a
    frame whose detection raises, for cv2's unreadable frames; the port's
    readers give well-formed arrays or raise ``ValueError`` for a corrupt
    file, so here an error is a fault (a kernel's build or launch
    included) and propagates."""
    if display:
        _no_display()
    n = 0
    with open_reader(video_path) as reader:
        detector = make_lane_detector(_config(config, device))
        vout = (open_writer(output_path, reader.width, reader.height,
                            output_fps(output_path, reader.fps))
                if output_path else None)
        try:
            for frame in reader:
                shown = detector.AutoDrawLanes(frame)
                if vout is not None:
                    vout.write(shown)
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        finally:
            if vout is not None:
                vout.close()
    return n


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Standalone lane detection")
    ap.add_argument("-i", "--input", required=True,
                    help="image (.png/.bmp/.jpg) or video "
                         "(.mp4/.mov/.avi/.h264/.h265/.265/.hevc/.y4m)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.display:
        _no_display()
    if args.input.lower().endswith(IMAGE_SUFFIXES):
        run_lane_image(args.input, args.output, device=args.device)
    else:
        n = run_lane_video(args.input, args.output, max_frames=args.max_frames,
                           device=args.device)
        print(f"processed {n} frames")


if __name__ == "__main__":
    main()
