"""Frontal <-> bird's-eye-view geometry for LDWS/LKAS: the parts of
``adas_tpu/analytics/perspective.py`` the serving path calls
(``updateTransformParams``, ``transformToBirdViewPoints``,
``calcCurveAndOffset`` without drawing), all host numpy.

Not ported yet: the image warps (``transformToBirdView`` /
``transformToFrontalView``, which need ``ops/warp.warp_perspective``) and
the cv2 drawing.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..ops.warp import get_perspective_transform, transform_points

YM_PER_PIX = 30 / 720
XM_PER_PIX = 3.7 / 700


class PerspectiveTransformation:
    """Maintains src/dst quads + homographies; projects lane points."""

    def __init__(self, img_size=(1280, 720)):
        self.img_size = img_size
        w, h = img_size
        self.src = np.float32(
            [(w * 0.3, h * 0.7), (w * 0.2, h), (w * 0.95, h), (w * 0.8, h * 0.7)]
        )
        offset_x = w / 4
        self.dst = np.float32(
            [(offset_x, 0), (offset_x, h), (w - offset_x, h), (w - offset_x, 0)]
        )
        self._update_matrices()

    def _update_matrices(self) -> None:
        self.M = get_perspective_transform(self.src, self.dst)
        self.M_inv = get_perspective_transform(self.dst, self.src)

    def updateTransformParams(
        self,
        left_lanes: Union[list, np.ndarray],
        right_lanes: Union[list, np.ndarray],
        type: str = "Default",
    ) -> None:
        """Re-fit the source trapezoid to the detected ego-lane extents."""
        left = np.asarray(left_lanes, dtype=np.float64).reshape(-1, 2)
        right = np.asarray(right_lanes, dtype=np.float64).reshape(-1, 2)
        if len(left) == 0 or len(right) == 0:
            return
        if type == "Top":
            top_y = min(left[:, 1].min(), right[:, 1].min())
            top_left = (left[:, 0].max() - 20, top_y)
            bottom_left = (self.src[1][0] - 10, self.src[1][1])
            bottom_right = (self.src[2][0] + 10, self.src[2][1])
            top_right = (right[:, 0].min() + 20, top_y)
        elif type == "Bottom":
            top_left = tuple(self.src[0])
            bottom_left = (left[:, 0].min() - 20, self.src[1][1])
            bottom_right = (right[:, 0].max() + 20, self.src[2][1])
            top_right = tuple(self.src[3])
        elif type == "Default":
            top_y = min(left[:, 1].min(), right[:, 1].min())
            top_left = (left[:, 0].max() - 20, top_y)
            bottom_left = (left[:, 0].min() - 5, self.src[1][1])
            bottom_right = (right[:, 0].max() + 5, self.src[2][1])
            top_right = (right[:, 0].min() + 20, top_y)
        else:
            return
        self.src = np.float32([top_left, bottom_left, bottom_right, top_right])
        self._update_matrices()

    def transformToBirdViewPoints(self, points) -> np.ndarray:
        """Project frontal-view lane points into bird view."""
        if points is None or len(points) == 0:
            return np.zeros((0, 2), dtype=int)
        out = transform_points(np.asarray(points), self.M)
        # near-horizon points blow up through the homography; keep ints
        # representable
        out = np.nan_to_num(out, posinf=2**30, neginf=-(2**30))
        return np.clip(out, -(2**30), 2**30).astype(np.int64)

    def calcCurveAndOffset(
        self, img: np.ndarray, left_lanes, right_lanes
    ) -> Tuple[Tuple[Optional[str], Optional[float]], Optional[float]]:
        """Curvature radius (m), direction ("L"/"R"/"F") and center offset
        (the JAX method with ``draw=False``); ``img`` gives the bird-view
        canvas size.  Lane width samples the bottom row of the bird image,
        as the JAX package does."""
        left = np.asarray(left_lanes, dtype=np.float64).reshape(-1, 2)
        right = np.asarray(right_lanes, dtype=np.float64).reshape(-1, 2)
        if len(left) < 3 or len(right) < 3:
            return (None, None), None

        left_fit = np.polyfit(left[:, 1], left[:, 0], 2)
        right_fit = np.polyfit(right[:, 1], right[:, 0], 2)
        side_cr = left_fit[0] if abs(left_fit[0]) > abs(right_fit[0]) else right_fit[0]
        if side_cr < -0.00015 and left[0, 0] <= left[len(left) // 2, 0]:
            direction = "L"
        elif side_cr > 0.00015 and right[0, 0] >= right[len(right) // 2, 0]:
            direction = "R"
        else:
            direction = "F"

        h = img.shape[0]
        ploty = np.arange(h, dtype=np.float64)
        leftx = np.polyval(left_fit, ploty)
        rightx = np.polyval(right_fit, ploty)
        y_eval = ploty[-1]

        left_fit_cr = np.polyfit(ploty * YM_PER_PIX, leftx * XM_PER_PIX, 2)
        right_fit_cr = np.polyfit(ploty * YM_PER_PIX, rightx * XM_PER_PIX, 2)

        def radius(fit):
            return ((1 + (2 * fit[0] * y_eval * YM_PER_PIX + fit[1]) ** 2) ** 1.5) / abs(
                2 * fit[0]
            )

        curvature = (radius(left_fit_cr) + radius(right_fit_cr)) / 2
        lane_width = abs(leftx[-1] - rightx[-1])
        lane_xm_per_pix = 3.7 / lane_width if lane_width > 0 else 0.0
        veh_pos = (leftx[-1] + rightx[-1]) / 2.0
        cen_pos = img.shape[1] / 2.0
        offset = (veh_pos - cen_pos) * lane_xm_per_pix
        return (direction, curvature), offset
