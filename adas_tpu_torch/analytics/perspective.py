"""Frontal <-> bird's-eye-view geometry for LDWS/LKAS (port of
``adas_tpu/analytics/perspective.py``): the trapezoid and its homographies,
point projection, the curvature/offset fit and the drawing on the host
(numpy and the port's cv2-free renderer), the image warps
(``transformToBirdView`` / ``transformToFrontalView``) on the device
through ``ops/warp.warp_perspective``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.types import LANE_COLORS, OffsetType

from ..ops.warp import get_perspective_transform, transform_points, warp_perspective
from ..render import draw as D
from ..render.text import FONT_HERSHEY_SIMPLEX, put_text

YM_PER_PIX = 30 / 720
XM_PER_PIX = 3.7 / 700

class PerspectiveTransformation:
    """Maintains src/dst quads + homographies; warps images (on ``device``,
    the card unless the caller names the CPU) and projects points."""

    def __init__(self, img_size=(1280, 720), logger=None, device="cuda"):
        self.img_size = img_size
        self.logger = logger
        self.device = torch.device(device)
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
        if self.logger is not None:
            self.logger.debug(
                f"Transform Type : {type} {top_left} {bottom_left} {bottom_right} {top_right}"
            )
        self.src = np.float32([top_left, bottom_left, bottom_right, top_right])
        self._update_matrices()

    def _warp(self, img: np.ndarray, matrix: np.ndarray) -> np.ndarray:
        """Upload ``img``, warp it by ``matrix`` to the frame size on the
        device, and return a writable host copy, as the JAX methods do."""
        w, h = self.img_size
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return warp_perspective(x, np.asarray(matrix, np.float32), (h, w)).cpu().numpy()

    def transformToBirdView(self, img: np.ndarray) -> np.ndarray:
        """Warp a frontal frame to bird view on the device."""
        return self._warp(img, self.M)

    def transformToFrontalView(self, img: np.ndarray) -> np.ndarray:
        """Warp a bird-view frame back to the frontal view on the device."""
        return self._warp(img, self.M_inv)

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
        self, img: np.ndarray, left_lanes, right_lanes, draw: bool = True
    ) -> Tuple[Tuple[Optional[str], Optional[float]], Optional[float]]:
        """Curvature radius (m), direction ("L"/"R"/"F") and center offset;
        ``img`` gives the bird-view canvas size.  Lane width samples the
        bottom row of the bird image, as the JAX package does.  ``draw``
        draws the vehicle and centre arrows and the two readings on
        ``img`` (``perspective.py:164-194``)."""
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

        if draw:
            # a degenerate fit can put veh_pos anywhere: clamp it near the
            # canvas as the JAX package does
            def _cx(v):
                if not np.isfinite(v):
                    return int(cen_pos)
                return int(np.clip(v, -img.shape[1], 2 * img.shape[1]))

            D.arrowed_line(img, (_cx(veh_pos), int(y_eval)), (_cx(veh_pos), int(img.shape[1] / 3)),
                           (255, 255, 255), 5, 0, 0, 0.2)
            D.arrowed_line(img, (int(cen_pos), int(y_eval)), (int(cen_pos), int(img.shape[0] / 1.3)),
                           (150, 150, 150), 10, 0, 0, 0.5)
            put_text(img, "Offset: %.1f m" % offset, (20, 80), FONT_HERSHEY_SIMPLEX, 3,
                     (0, 0, 255), 5)
            put_text(img, "R : %.1f m" % curvature, (20, 180), FONT_HERSHEY_SIMPLEX, 3,
                     (0, 0, 255), 5)
        return (direction, curvature), offset

    def DrawDetectedOnBirdView(self, image: np.ndarray, lanes_points,
                               type: OffsetType = OffsetType.UNKNOWN) -> None:
        """The bird-view lane points as radius-10 discs, the departing ego
        lane in red (``perspective.py:196``); points that are not finite or
        lie farther than a canvas size outside it are skipped, as the JAX
        package skips them."""
        h, w = image.shape[:2]
        for lane_num, lane_points in enumerate(lanes_points):
            if lane_num == 1 and type == OffsetType.RIGHT:
                color = (0, 0, 255)
            elif lane_num == 2 and type == OffsetType.LEFT:
                color = (0, 0, 255)
            else:
                color = LANE_COLORS[lane_num]
            pts = np.asarray(lane_points, dtype=np.float64).reshape(-1, 2)
            x, y = pts[:, 0], pts[:, 1]
            keep = np.isfinite(x) & np.isfinite(y) & (x >= -w) & (x <= 2 * w) \
                & (y >= -h) & (y <= 2 * h)
            D.circles(image, [(int(a), int(b)) for a, b in pts[keep]], 10, color, -1)

    def DrawTransformFrontalViewArea(self, image: np.ndarray) -> None:
        """The source trapezoid's outline in red (``perspective.py:225``)."""
        pts = self.src.astype(int)
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
            D.line(image, tuple(pts[a]), tuple(pts[b]), (0, 0, 255), 5)
