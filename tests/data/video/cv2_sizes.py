"""The file size and quality of cv2's ``mp4v`` writer against the port's
(``adas_tpu_torch/render/video.MP4Writer``) on the same seeded 720x1280
frames.  Needs cv2 (built with FFmpeg); run from the repository root:

    python tests/data/video/cv2_sizes.py [--frames 24]

Two contents: ``noise``, ``run_synthetic``'s seeded input frames without
the HUD, and ``synthetic-pan``, made-up smooth colour frames panning 6 px
a frame with a little grain (not a recorded clip).  One JSON line per
content: MiB per second of video at 30 fps and the least Y PSNR against
the source, for cv2's file (cv2's Y planes read with
``CAP_PROP_CONVERT_RGB`` 0) and for the port's (its own decode).
"""
import argparse
import json
import os
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from adas_tpu_torch.ops.preprocess import bgr_to_i420  # noqa: E402
from adas_tpu_torch.render.video import MP4Reader, MP4Writer  # noqa: E402

HW = (720, 1280)


def noise_frames(n: int):
    """``run_synthetic``'s seeded noise frames."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (*HW, 3), dtype=np.uint8) for _ in range(n)]


def pan_frames(n: int, speed: int = 6, seed: int = 0):
    """Made-up smooth colour frames panning ``speed`` px a frame, with grain."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float32)
    frames = []
    for t in range(n):
        xs = x + speed * t
        b = 128 + 60 * np.sin(xs / 13.0) * np.cos(y / 17.0) + 40 * np.sin((xs + y) / 29.0)
        g = 128 + 70 * np.cos(xs / 23.0) + 30 * np.sin(y / 7.0)
        r = 128 + 80 * np.sin((xs - 2 * y) / 31.0)
        img = np.stack([b, g, r], -1) + rng.normal(0, 2, (*HW, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _row(path, psnr, n):
    mib = os.path.getsize(path) / 2 ** 20
    return {"mib": mib, "mib_per_s": mib * 30.0 / n, "min_y_psnr_db": float(min(psnr))}


def port_row(frames, path):
    h, w = HW
    with MP4Writer(path, w, h, 30.0) as vw:
        for f in frames:
            vw.write(f)
    with MP4Reader(path) as r:
        psnr = [_psnr(p[:h], bgr_to_i420(f)[:h]) for p, f in zip(r.i420_frames(), frames)]
    return _row(path, psnr, len(frames))


def cv2_row(frames, path):
    h, w = HW
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    psnr = []
    for f in frames:
        ok, y = cap.read()
        assert ok
        psnr.append(_psnr(y, bgr_to_i420(f)[:h]))
    return _row(path, psnr, len(frames))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in (("synthetic-pan", pan_frames), ("noise", noise_frames)):
            frames = make(args.frames)
            print(json.dumps({"content": name, "frames": len(frames),
                              "cv2": cv2_row(frames, os.path.join(tmp, "cv2.mp4")),
                              "port": port_row(frames, os.path.join(tmp, "port.mp4"))}),
                  flush=True)


if __name__ == "__main__":
    main()
