"""Tracker base: class-color management + host-side render helpers.

Behavioral parity with reference ObjectTracker/core.py (direction arrows
with a shift gate, shrinking "lock-on" indicator during the first frames
of a track, trajectory dots growing with recency, tinted bbox overlay).
Rendering is deliberately host-side OpenCV — it is the visualization
shell, not a perf path (SURVEY.md §2.2).
"""
from __future__ import annotations

import math
from abc import ABCMeta, abstractmethod
from typing import Any, Dict, List, Union

import numpy as np

FONT_SCALE = 6e-4
THICKNESS_SCALE = 2e-3


def putText_shadow(
    img, text, org, fontFace, fontScale, color,
    thickness=1, shadow_color=(200, 200, 200), shadow_offset=2,
):
    import cv2

    cv2.putText(
        img, text, (org[0] + shadow_offset, org[1] + shadow_offset),
        fontFace - 1, fontScale, shadow_color, thickness=thickness + 1,
    )
    cv2.putText(
        img, text, org, fontFace, fontScale, color, thickness=thickness
    )


def arrowedLine_shadow(
    img, start, end, color,
    thickness=3, tipLength=0.3, shadow_color=(100, 100, 100), shadow_offset=2,
):
    import cv2

    cv2.arrowedLine(
        img,
        (start[0] - shadow_offset, start[1] + shadow_offset),
        (end[0] - shadow_offset, end[1] + shadow_offset),
        shadow_color, thickness=thickness + 2, tipLength=tipLength,
    )
    cv2.arrowedLine(
        img, start,
        (end[0] - shadow_offset // 2, end[1] - shadow_offset // 2),
        color, thickness=thickness - 1, tipLength=tipLength - 0.1,
    )
    cv2.arrowedLine(
        img, start, end, color, thickness=thickness, tipLength=tipLength
    )


class ObjectTrackBase(metaclass=ABCMeta):
    """Shared tracker surface: per-class colors + drawing primitives."""

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
    def _compute_directions(
        trajectories: List[np.ndarray], limit_shift: int = 2
    ) -> List:
        """Per-step center motion vectors; steps with box shift below the
        gate contribute a zero vector (noise suppression)."""
        directions = []
        for cur, nxt in zip(trajectories, trajectories[1:]):
            shift = abs(min(np.asarray(nxt) - np.asarray(cur)))
            c0 = np.array([(cur[0] + cur[2]) / 2, (cur[1] + cur[3]) / 2])
            c1 = np.array([(nxt[0] + nxt[2]) / 2, (nxt[1] + nxt[3]) / 2])
            directions.append(c1 - c0 if shift >= limit_shift else [0, 0])
        return directions

    def plot_directions(self, img, init_point, observations, class_id):
        """Median-direction arrow once enough history exists; before that,
        a shrinking lock-on rectangle."""
        import cv2

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
            cv2.rectangle(img, (sx, sy), (ex, ey), color, 2, cv2.LINE_8)
        else:
            arrow_length = 1000 * min(
                (h * w) / (img.shape[0] * img.shape[1]), 0.02
            )
            mean_dir = np.median(directions, axis=0)
            end = (
                int(cx + mean_dir[0] * arrow_length),
                int(cy + mean_dir[1] * arrow_length),
            )
            arrowedLine_shadow(
                img, (int(cx), int(cy)), end, (255, 255, 255),
                thickness=3, tipLength=0.3,
            )

    def plot_trajectories(self, img, observations, class_id, track_id):
        import cv2

        if len(observations) <= 1:
            return
        for i, box in enumerate(observations):
            cx, ey = int((box[0] + box[2]) / 2), int(box[3])
            cv2.circle(
                img, (cx, ey),
                int(np.sqrt(float(i + 1)) * 0.5),
                color=self.class_colors[class_id],
                thickness=int(np.sqrt(float(i + 1)) * 1.2),
            )
        font_size = min(1, sum(box[2:]) * FONT_SCALE)
        putText_shadow(
            img, f"ID: {track_id}",
            (int(box[0] + 10 * font_size), int(box[1] + 30 * font_size)),
            fontFace=cv2.FONT_HERSHEY_TRIPLEX,
            fontScale=font_size,
            color=self.class_colors[class_id],
            thickness=1,
            shadow_color=tuple(i - 30 for i in self.class_colors[class_id]),
        )

    def plot_bbox(self, img, observation, class_id, track_id):
        import cv2

        if len(observation) <= 1:
            return
        tx1, ty1, tw, th = np.asarray(observation).astype(int)
        x1, y1 = max(0, tx1), max(0, ty1)
        x2 = min(img.shape[1], tx1 + tw)
        y2 = min(img.shape[0], ty1 + th)
        color = self.class_colors[class_id]
        cv2.putText(
            img, f"{self.names[class_id]} : {track_id}", (tx1, ty1 - 10),
            fontFace=cv2.FONT_HERSHEY_TRIPLEX,
            fontScale=min(1, tw * th) * FONT_SCALE,
            thickness=math.ceil(min(*img.shape[:2]) * THICKNESS_SCALE),
            color=color,
        )
        cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness=2)
        det = img[y1:y2, x1:x2, :].copy()
        mask = np.ones(det.shape, dtype=np.uint8) * np.uint8(color)
        img[y1:y2, x1:x2] = cv2.addWeighted(det, 0.6, mask, 0.4, 1.0)
