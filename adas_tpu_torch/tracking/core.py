"""Tracker base: class-colour management and the host-side render helpers
(the port's copy of ``adas_tpu/tracking/core.py``): direction arrows with
a shift gate, the shrinking lock-on box of a young track, trajectory dots
growing with recency, the tinted box, drawn with the port's cv2-free
renderer (``render/``)."""
from __future__ import annotations

import math
from abc import ABCMeta, abstractmethod
from typing import Any, Dict, List, Union

import numpy as np

from ..render import draw as D
from ..render.text import FONT_HERSHEY_TRIPLEX, put_text

FONT_SCALE = 6e-4
THICKNESS_SCALE = 2e-3


def putText_shadow(
    img, text, org, fontFace, fontScale, color,
    thickness=1, shadow_color=(200, 200, 200), shadow_offset=2,
):
    """The text over its shadow, which is drawn ``shadow_offset`` down and
    right in face ``fontFace - 1`` one thicker."""
    put_text(img, text, (org[0] + shadow_offset, org[1] + shadow_offset), fontFace - 1,
             fontScale, shadow_color, thickness + 1)
    put_text(img, text, org, fontFace, fontScale, color, thickness)


def arrowedLine_shadow(
    img, start, end, color,
    thickness=3, tipLength=0.3, shadow_color=(100, 100, 100), shadow_offset=2,
):
    D.arrowed_line(
        img, (start[0] - shadow_offset, start[1] + shadow_offset),
        (end[0] - shadow_offset, end[1] + shadow_offset),
        shadow_color, thickness + 2, tip_length=tipLength,
    )
    D.arrowed_line(img, start, (end[0] - shadow_offset // 2, end[1] - shadow_offset // 2),
                   color, thickness - 1, tip_length=tipLength - 0.1)
    D.arrowed_line(img, start, end, color, thickness, tip_length=tipLength)


class ObjectTrackBase(metaclass=ABCMeta):
    """Shared tracker surface: per-class colours + drawing primitives."""

    def __init__(self, names: Union[List[str], Dict[str, tuple]]):
        self.names = names
        if isinstance(names, dict):
            self.class_colors = names
            self.names = {k: k for k in names}
        else:
            rng = np.random.default_rng()
            self.class_colors = [
                rng.integers(0, 255, size=3, dtype=np.uint8).tolist()
                for _ in names
            ]

    @abstractmethod
    def update(self, *args, **kwargs) -> List[Any]:
        """Advance tracker state by one frame of detections."""

    @staticmethod
    def _compute_directions(trajectories: List[np.ndarray], limit_shift: int = 2) -> List:
        """Per-step centre motion vectors; steps with box shift below the
        gate contribute a zero vector (noise suppression).  The JAX loop,
        vectorized: the same float64 operations per step."""
        if len(trajectories) < 2:
            return []
        t = np.asarray(trajectories, dtype=np.float64)
        shift = np.abs((t[1:] - t[:-1]).min(axis=1))
        cx, cy = (t[:, 0] + t[:, 2]) / 2, (t[:, 1] + t[:, 3]) / 2
        steps = np.stack([cx[1:] - cx[:-1], cy[1:] - cy[:-1]], axis=1)
        steps[shift < limit_shift] = 0
        return list(steps)

    def plot_directions(self, img, init_point, observations, class_id):
        """Median-direction arrow once enough history exists; before that,
        a shrinking lock-on rectangle."""
        lock_count = 5
        directions = self._compute_directions(observations)
        if len(observations) <= 1:
            return
        cx, cy, rate, h = init_point
        w = h * rate
        if len(directions) < lock_count:
            rate_w = (cx - (cx - w // 2)) / lock_count
            rate_h = (cy - (cy - h // 2)) / lock_count
            sx = int(cx - w // 2 + rate_w * len(directions))
            sy = int(cy - h // 2 + rate_h * len(directions))
            ex = int(cx + w // 2 - rate_w * len(directions))
            ey = int(cy + h // 2 - rate_h * len(directions))
            color = tuple(i - 10 for i in self.class_colors[class_id])
            D.rectangle(img, (sx, sy), (ex, ey), color, 2, D.LINE_8)
        else:
            arrow_length = 1000 * min((h * w) / (img.shape[0] * img.shape[1]), 0.02)
            mean_dir = np.median(directions, axis=0)
            end = (int(cx + mean_dir[0] * arrow_length), int(cy + mean_dir[1] * arrow_length))
            arrowedLine_shadow(img, (int(cx), int(cy)), end, (255, 255, 255),
                               thickness=3, tipLength=0.3)

    def plot_trajectories(self, img, observations, class_id, track_id):
        if len(observations) <= 1:
            return
        # dot i: radius int(0.5 * sqrt(i + 1)) (0 for the first three: one
        # pixel, or a radius-1 disc from the thick outline), thickness
        # int(1.2 * sqrt(i + 1)); all in one native call, in order
        grow = np.sqrt(np.arange(1, len(observations) + 1, dtype=np.float64))
        D.circles(img, [(int((b[0] + b[2]) / 2), int(b[3])) for b in observations],
                  (grow * 0.5).astype(np.int32), self.class_colors[class_id],
                  (grow * 1.2).astype(np.int32))
        box = observations[-1]
        font_size = min(1, sum(box[2:]) * FONT_SCALE)
        putText_shadow(
            img, f"ID: {track_id}",
            (int(box[0] + 10 * font_size), int(box[1] + 30 * font_size)),
            fontFace=FONT_HERSHEY_TRIPLEX,
            fontScale=font_size,
            color=self.class_colors[class_id],
            thickness=1,
            shadow_color=tuple(i - 30 for i in self.class_colors[class_id]),
        )

    def plot_bbox(self, img, observation, class_id, track_id):
        if len(observation) <= 1:
            return
        tx1, ty1, tw, th = np.asarray(observation).astype(int)
        x1, y1 = max(0, tx1), max(0, ty1)
        x2 = min(img.shape[1], tx1 + tw)
        y2 = min(img.shape[0], ty1 + th)
        color = self.class_colors[class_id]
        put_text(img, f"{self.names[class_id]} : {track_id}", (tx1, ty1 - 10),
                 FONT_HERSHEY_TRIPLEX, min(1, tw * th) * FONT_SCALE, color,
                 math.ceil(min(*img.shape[:2]) * THICKNESS_SCALE))
        D.rectangle(img, (x1, y1), (x2, y2), color, 2)
        det = img[y1:y2, x1:x2, :].copy()
        mask = np.ones(det.shape, dtype=np.uint8) * np.uint8(color)
        img[y1:y2, x1:x2] = D.add_weighted(det, 0.6, mask, 0.4, 1.0)
