"""FCWS single-camera distance estimation (port of
``adas_tpu/analytics/distance.py``; it draws with the port's cv2-free
renderer).

Behavior parity with reference ObjectDetector/distanceMeasure.py: pinhole
distance from box pixel height against per-class reference heights
(d = refH·f / pixH, f=100, inches→feet→meters), filtered to six road-user
classes and boxes with ymax ≤ 650; nearest in-lane point selection via
point-in-polygon test against the detected ego-lane area.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.types import RectInfo

from ..render import draw as D
from ..render.text import FONT_HERSHEY_TRIPLEX, get_text_size
from ..tracking.core import putText_shadow

INCH = 0.39

#: (height, width) of reference objects in inches (from cm · 0.39).
REF_SIZE = {
    "person": (160 * INCH, 50 * INCH),
    "bicycle": (98 * INCH, 65 * INCH),
    "motorbike": (100 * INCH, 100 * INCH),
    "car": (150 * INCH, 180 * INCH),
    "bus": (319 * INCH, 250 * INCH),
    "truck": (346 * INCH, 250 * INCH),
}


def point_in_polygon(pt, poly: np.ndarray) -> bool:
    """Even-odd ray-cast point-in-polygon test (host-side, tiny)."""
    poly = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    x, y = float(pt[0]), float(pt[1])
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi
            if x < x_cross:
                inside = not inside
        j = i
    return inside


class SingleCamDistanceMeasure:
    """Monocular distance from bounding-box pixel height."""

    DEFAULT_CLASSES = ["person", "bicycle", "car", "motorbike", "bus", "truck"]

    def __init__(self, object_list: Optional[List[str]] = None):
        self.object_list = object_list or list(self.DEFAULT_CLASSES)
        self.f = 100  # focal length proxy (reference distanceMeasure.py:21)
        self.distance_points: List[list] = []

    def updateDistance(self, boxes: List[RectInfo]) -> None:
        """Recompute [x_center, y_bottom, distance_m] per eligible box."""
        self.distance_points = []
        for box in boxes:
            xmin, ymin, xmax, ymax = box.tolist()
            label = box.label
            if label not in self.object_list or ymax > 650:
                continue
            if label not in REF_SIZE or ymax - ymin <= 0:
                continue
            point_x = (xmax + xmin) // 2
            point_y = ymax
            d_inch = (REF_SIZE[label][0] * self.f) / (ymax - ymin)
            d_m = d_inch / 12 * 0.3048  # inches→feet→meters
            self.distance_points.append([point_x, point_y, d_m])

    def calcCollisionPoint(self, poly) -> Optional[list]:
        """Nearest measured point lying inside the ego-lane polygon."""
        if len(self.distance_points) == 0 or poly is None or len(poly) == 0:
            return None
        poly = np.asarray(poly).reshape(-1, 2)
        for x, y, d in sorted(self.distance_points, key=lambda p: p[2]):
            if point_in_polygon((x, y), poly):
                return [x, y, d]
        return None

    def DrawDetectedOnFrame(self, frame_show: np.ndarray) -> None:
        """Each measured point as a white disc with its distance beneath
        (``distance.py:83``): the label sized with font 0 at thickness 3,
        drawn in TRIPLEX over a COMPLEX shadow."""
        for x, y, d in self.distance_points:
            D.circle(frame_show, (int(x), int(y)), 4, (255, 255, 255), -1)
            text = " unknown m" if d < 0 else " {:.2f} m".format(d)
            font_scale = max(0.4, min(1, 1 / d)) if d > 0 else 0.4
            size = get_text_size(text, 0, font_scale, 3)[0]
            tx = int(x - size[0] / 2)
            ty = int(y + size[1])
            putText_shadow(frame_show, text, (tx + 1, ty + 5), fontFace=FONT_HERSHEY_TRIPLEX,
                           fontScale=font_scale, color=(255, 255, 255), thickness=1,
                           shadow_color=(150, 150, 150))
