"""HUD control panel: bird-view inset, signs panel, collision panel (port of
``adas_tpu/pipeline/panel.py``) on the port's cv2-free renderer
(``render/``).

The nine icons are procedural, as in the JAX package (the reference's PNG
assets are not shipped), and equal the JAX package's to the pixel; they
scatter onto the frame where their alpha (or, for the lane icons, their
red) channel is non-zero.  Every quirk is kept: ``widget[-3:-1]`` paints
two border rows, the fixed 400x365 signs widget is clipped on small
frames, the curve status keeps its hysteresis.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..render import draw as D
from ..render.text import FONT_HERSHEY_SIMPLEX, FONT_HERSHEY_TRIPLEX, put_text
from ..utils.types import CollisionType, CurvatureType, OffsetType


def _blank(w: int, h: int) -> np.ndarray:
    return np.zeros((h, w, 4), dtype=np.uint8)


def _arrow_icon(size: int = 200, direction: str = "up") -> np.ndarray:
    """Procedural turn-arrow icon (RGBA), white on transparent; the left
    and right arrows are the up arrow turned by cv2's +-90 degree warp."""
    img = _blank(size, size)
    s = size
    shaft = [[s // 2 - s // 12, int(s * 0.85)], [s // 2 + s // 12, int(s * 0.85)],
             [s // 2 + s // 12, int(s * 0.45)], [s // 2 - s // 12, int(s * 0.45)]]
    head = [[s // 2 - s // 5, int(s * 0.45)], [s // 2 + s // 5, int(s * 0.45)],
            [s // 2, int(s * 0.18)]]
    D.fill_poly(img, [shaft], (255, 255, 255, 255))
    D.fill_poly(img, [head], (255, 255, 255, 255))
    if direction == "left":
        img = D.rotate_icon(img, 90)
    elif direction == "right":
        img = D.rotate_icon(img, -90)
    return img


def _warn_icon(size: int = 200) -> np.ndarray:
    """Yellow warning triangle with '!' (RGBA)."""
    img = _blank(size, size)
    s = size
    tri = [[s // 2, int(s * 0.1)], [int(s * 0.08), int(s * 0.9)], [int(s * 0.92), int(s * 0.9)]]
    D.fill_poly(img, [tri], (0, 215, 255, 255))
    put_text(img, "!", (s // 2 - s // 12, int(s * 0.78)), FONT_HERSHEY_TRIPLEX, s / 70,
             (0, 0, 0, 255), max(2, s // 40))
    return img


def _collision_icon(size: int = 100, color=(0, 255, 0)) -> np.ndarray:
    """Car-ahead FCWS icon (RGBA): coloured disc + car glyph."""
    img = _blank(size, size)
    s = size
    D.circle(img, (s // 2, s // 2), int(s * 0.45), (*color, 255), -1)
    D.rectangle(img, (int(s * 0.3), int(s * 0.42)), (int(s * 0.7), int(s * 0.62)),
                (255, 255, 255, 255), -1)
    D.rectangle(img, (int(s * 0.37), int(s * 0.3)), (int(s * 0.63), int(s * 0.44)),
                (255, 255, 255, 255), -1)
    for cx in (0.37, 0.63):
        D.circle(img, (int(s * cx), int(s * 0.66)), int(s * 0.06), (40, 40, 40, 255), -1)
    return img


def _lane_departure_icon(w: int = 300, h: int = 200, side: str = "left"):
    """Lane-keeping-assist icon: two lane lines + red arrow to one side."""
    img = _blank(w, h)
    D.line(img, (w // 3, h - 10), (w // 2 - 20, 10), (255, 255, 255, 255), 8)
    D.line(img, (2 * w // 3, h - 10), (w // 2 + 20, 10), (255, 255, 255, 255), 8)
    y = h // 2
    if side == "left":
        D.arrowed_line(img, (w // 2 + 40, y), (w // 2 - 70, y), (0, 0, 255, 255), 10,
                       tip_length=0.4)
    else:
        D.arrowed_line(img, (w // 2 - 40, y), (w // 2 + 70, y), (0, 0, 255, 255), 10,
                       tip_length=0.4)
    return img


class ControlPanel:
    """Renders the three HUD widgets onto the output frame."""

    CollisionDict = {
        CollisionType.UNKNOWN: (0, 255, 255),
        CollisionType.NORMAL: (0, 255, 0),
        CollisionType.PROMPT: (0, 102, 255),
        CollisionType.WARNING: (0, 0, 255),
    }
    OffsetDict = {
        OffsetType.UNKNOWN: (0, 255, 255),
        OffsetType.RIGHT: (0, 0, 255),
        OffsetType.LEFT: (0, 0, 255),
        OffsetType.CENTER: (0, 255, 0),
    }
    CurvatureDict = {
        CurvatureType.UNKNOWN: (0, 255, 255),
        CurvatureType.STRAIGHT: (0, 255, 0),
        CurvatureType.EASY_LEFT: (0, 102, 255),
        CurvatureType.EASY_RIGHT: (0, 102, 255),
        CurvatureType.HARD_LEFT: (0, 0, 255),
        CurvatureType.HARD_RIGHT: (0, 0, 255),
    }

    def __init__(self):
        self.collision_warning_img = _collision_icon(100, (0, 0, 255))
        self.collision_prompt_img = _collision_icon(100, (0, 102, 255))
        self.collision_normal_img = _collision_icon(100, (0, 255, 0))
        self.left_curve_img = _arrow_icon(200, "left")
        self.right_curve_img = _arrow_icon(200, "right")
        self.keep_straight_img = _arrow_icon(200, "up")
        self.determined_img = _warn_icon(200)
        self.left_lanes_img = _lane_departure_icon(300, 200, "left")
        self.right_lanes_img = _lane_departure_icon(300, 200, "right")

        self.fps = 0.0
        self.frame_count = 0
        self.start = time.time()
        self.curve_status: Optional[str] = None

    def _updateFPS(self) -> None:
        self.frame_count += 1
        if self.frame_count >= 30:
            end = time.time()
            self.fps = self.frame_count / (end - self.start)
            self.frame_count = 0
            self.start = time.time()

    @staticmethod
    def _overlay(main_show, icon, dy, dx, alpha_ch=3):
        """Scatter icon pixels where the given channel is non-zero, with
        bounds clipping."""
        y, x = icon[:, :, alpha_ch].nonzero()
        yy = y + dy
        xx = x + dx
        ok = (yy >= 0) & (yy < main_show.shape[0]) & (xx >= 0) & (xx < main_show.shape[1])
        main_show[yy[ok], xx[ok]] = icon[y[ok], x[ok], :3]

    def DisplayBirdViewPanel(self, main_show, min_show, show_ratio=0.25):
        w = int(main_show.shape[1] * show_ratio)
        h = int(main_show.shape[0] * show_ratio)
        inset = D.copy_make_border(D.resize_linear(min_show, (w, h)), 10, 10, 10, 10, 0)
        main_show[: inset.shape[0], -inset.shape[1]:] = inset

    def DisplaySignsPanel(self, main_show, offset_type, curvature_type):
        w, h = 400, 365
        widget = main_show[:h, :w].copy()
        widget //= 2
        widget[0:3, :] = [0, 0, 255]
        widget[-3:-1, :] = [0, 0, 255]
        widget[:, 0:3] = [0, 0, 255]
        widget[:, -3:-1] = [0, 0, 255]
        main_show[:h, :w] = widget

        if curvature_type == CurvatureType.UNKNOWN and offset_type in {
            OffsetType.UNKNOWN, OffsetType.CENTER,
        }:
            self._overlay(main_show, self.determined_img, 10, w // 2 - 100)
            self.curve_status = None
        elif (
            curvature_type == CurvatureType.HARD_LEFT or self.curve_status == "Left"
        ) and curvature_type not in {CurvatureType.EASY_RIGHT, CurvatureType.HARD_RIGHT}:
            self._overlay(main_show, self.left_curve_img, 10, w // 2 - 100)
            self.curve_status = "Left"
        elif (
            curvature_type == CurvatureType.HARD_RIGHT or self.curve_status == "Right"
        ) and curvature_type not in {CurvatureType.EASY_LEFT, CurvatureType.HARD_LEFT}:
            self._overlay(main_show, self.right_curve_img, 10, w // 2 - 100)
            self.curve_status = "Right"

        if offset_type == OffsetType.RIGHT:
            self._overlay(main_show, self.left_lanes_img, 10, w // 2 - 150, alpha_ch=2)
        elif offset_type == OffsetType.LEFT:
            self._overlay(main_show, self.right_lanes_img, 10, w // 2 - 150, alpha_ch=2)
        elif curvature_type == CurvatureType.STRAIGHT or self.curve_status == "Straight":
            self._overlay(main_show, self.keep_straight_img, 10, w // 2 - 100)
            self.curve_status = "Straight"

        self._updateFPS()
        put_text(main_show, "LDWS : " + offset_type.value, (10, 240), FONT_HERSHEY_SIMPLEX, 0.7,
                 self.OffsetDict[offset_type], 2)
        put_text(main_show, "LKAS : " + curvature_type.value, (10, 280), FONT_HERSHEY_SIMPLEX,
                 0.7, self.CurvatureDict[curvature_type], 2)
        put_text(main_show, "FPS  : %.2f" % self.fps, (10, widget.shape[0] - 20),
                 FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2, D.LINE_AA)

    def DisplayCollisionPanel(
        self, main_show, collision_type, object_infer_time, lane_infer_time, show_ratio=0.25,
    ):
        w = int(main_show.shape[1] * show_ratio)
        h = int(main_show.shape[0] * show_ratio)
        widget = main_show[h + 20: 2 * h, -w - 20:].copy()
        widget //= 2
        widget[0:3, :] = [0, 0, 255]
        widget[-3:-1, :] = [0, 0, 255]
        widget[:, -3:-1] = [0, 0, 255]
        widget[:, 0:3] = [0, 0, 255]
        main_show[h + 20: 2 * h, -w - 20:] = widget

        icon = {
            CollisionType.WARNING: self.collision_warning_img,
            CollisionType.PROMPT: self.collision_prompt_img,
            CollisionType.NORMAL: self.collision_normal_img,
        }.get(collision_type)
        if icon is not None:
            self._overlay(main_show, icon, h + 50, main_show.shape[1] - w - 5)

        x = main_show.shape[1] - w + 100
        put_text(main_show, "FCWS : " + collision_type.value, (x, 240), FONT_HERSHEY_SIMPLEX,
                 0.6, self.CollisionDict[collision_type], 2)
        put_text(main_show, "object-infer : %.2f s" % object_infer_time, (x, 300),
                 FONT_HERSHEY_SIMPLEX, 0.5, (230, 230, 230), 1, D.LINE_AA)
        put_text(main_show, "lane-infer : %.2f s" % lane_infer_time, (x, 320),
                 FONT_HERSHEY_SIMPLEX, 0.5, (230, 230, 230), 1, D.LINE_AA)
