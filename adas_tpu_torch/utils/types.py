"""Core value types and enums shared across the framework.

Public surface mirrors the reference framework's enums and dataclasses so a
user of jason-li-831202/Vehicle-CV-ADAS can switch over without relearning
the vocabulary (reference: ObjectDetector/utils.py:8-23, ObjectDetector/core.py:8-33,
TrafficLaneDetector/ufldDetector/utils.py:1-24,
TrafficLaneDetector/ufldDetector/core.py:7-50).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple

import numpy as np


class ObjectModelType(Enum):
    """Supported object-detection model families."""

    YOLOV5 = 0
    YOLOV5_LITE = 1
    YOLOV6 = 2
    YOLOV7 = 3
    YOLOV8 = 4
    YOLOV9 = 5
    YOLOV10 = 6
    EfficientDet = 7


class LaneModelType(Enum):
    """Supported lane-detection model variants."""

    UFLD_TUSIMPLE = 0
    UFLD_CULANE = 1
    UFLDV2_TUSIMPLE = 2
    UFLDV2_CULANE = 3
    UFLDV2_CURVELANES = 4


class OffsetType(Enum):
    """LDWS lane-offset status."""

    UNKNOWN = "To Be Determined ..."
    RIGHT = "Please Keep Right"
    LEFT = "Please Keep Left"
    CENTER = "Good Lane Keeping"


class CurvatureType(Enum):
    """LKAS road-curvature status."""

    UNKNOWN = "To Be Determined ..."
    STRAIGHT = "Keep Straight Ahead"
    EASY_LEFT = "Gentle Left Curve Ahead"
    HARD_LEFT = "Hard Left Curve Ahead"
    EASY_RIGHT = "Gentle Right Curve Ahead"
    HARD_RIGHT = "Hard Right Curve Ahead"


class CollisionType(Enum):
    """FCWS forward-collision status."""

    UNKNOWN = "Determined ..."
    NORMAL = "Normal Risk"
    PROMPT = "Prompt Risk"
    WARNING = "Warning Risk"


#: Default per-lane draw colors (BGR), indexed left-side..right-side.
LANE_COLORS: List[Tuple[int, int, int]] = [
    (255, 0, 0),
    (46, 139, 87),
    (50, 205, 50),
    (0, 255, 255),
]


def hex_to_rgb(value: str) -> Tuple[int, ...]:
    """Convert a ``#rrggbb`` hex string to an (r, g, b) int tuple."""
    value = value.lstrip("#")
    step = len(value) // 3
    return tuple(int(value[i : i + step], 16) for i in range(0, len(value), step))


@dataclass
class RectInfo:
    """One detected object box in original-image pixel coordinates.

    ``x, y`` are the top-left corner; ``kpss`` optionally holds keypoints.
    API parity with reference ObjectDetector/core.py:8-33.
    """

    x: float
    y: float
    width: float
    height: float
    conf: float
    label: str
    kpss: List[Tuple[int, int]] = field(default_factory=list)

    def tolist(self, dtype=int, format_type: str = "xyxy") -> list:
        if format_type == "xyxy":
            vals = [self.x, self.y, self.x + self.width, self.y + self.height]
        else:
            vals = [self.x, self.y, self.width, self.height]
        return [dtype(v) for v in vals]

    def pad(self, padding: int) -> "RectInfo":
        return RectInfo(
            x=self.x - padding,
            y=self.y - padding,
            width=self.width + 2 * padding,
            height=self.height + 2 * padding,
            conf=self.conf,
            label=self.label,
            kpss=self.kpss,
        )


#: Canonical lane keys, ordered left to right.
LANE_KEYS = ("left-side", "left-ego", "right-ego", "right-side")


@dataclass
class LaneInfo:
    """Decoded lane points plus the drivable-area polygon derived from the
    two ego lanes.  Mutation of the area fields goes through
    ``update_status``/``update_area`` so status and polygon never diverge
    (parity with reference core.py:143-158 behavior).
    """

    lanes_points: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=object)
    )
    lanes_status: list = field(default_factory=list)
    _area_points: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=object)
    )
    _area_status: bool = False

    @property
    def area_status(self) -> bool:
        return self._area_status

    @property
    def area_points(self) -> np.ndarray:
        return self._area_points

    def update_status(self) -> None:
        """Area is valid iff both ego lanes (the middle pair) are detected."""
        self._area_status = False
        status = list(self.lanes_status)
        if status and len(status) % 2 == 0:
            mid = len(status) // 2
            if status[mid - 1] and status[mid]:
                self._area_status = True

    def update_area(self, img_height: int, adjust_lanes: bool = False) -> None:
        """Build the drivable-area polygon from the ego lane pair.

        The polygon walks down the left-ego lane and back up the (flipped)
        right-ego lane.  With ``adjust_lanes`` the points are first smoothed
        with a quadratic fit (reference core.py:102-141).
        """
        self._area_points = np.array([], dtype=object)
        if not self._area_status:
            return
        mid = len(self.lanes_points) // 2
        left, right = self.lanes_points[mid - 1], self.lanes_points[mid]
        if adjust_lanes:
            left, right = _smooth_lane_pair(left, right, img_height)
        if len(left) and len(right):
            self._area_points = np.vstack(
                (np.asarray(left), np.flipud(np.asarray(right)))
            )


def _smooth_lane_pair(
    left_points, right_points, image_height: int
) -> Tuple[list, list]:
    """Quadratic-fit smoothing of an ego lane pair.

    Requires >10 points on each lane, otherwise returns inputs unchanged
    (reference core.py:102-141 semantics).
    """
    left_points = list(left_points)
    right_points = list(right_points)
    if len(left_points) <= 10 or len(right_points) <= 10:
        return left_points, right_points

    lx, ly = zip(*left_points)
    rx, ry = zip(*right_points)
    left_fit = np.polyfit(ly, lx, 2)
    right_fit = np.polyfit(ry, rx, 2)

    maxy = max(image_height - 1, max(ly), max(ry))
    miny = min(image_height // 3, min(ly), min(ry))
    ys = np.linspace(miny, maxy, image_height)
    left_xs = np.polyval(left_fit, ys)
    right_xs = np.polyval(right_fit, ys)

    fixed_left = [
        (int(x), int(y)) for x, y in zip(left_xs, ys) if y >= min(ly) and x >= 0
    ]
    fixed_right = [
        (int(x), int(y)) for x, y in zip(right_xs, ys) if y >= min(ry) and x >= 0
    ]
    return fixed_left, fixed_right
