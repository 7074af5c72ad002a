"""UFLDv2 lane detector facade (port of ``UltrafastLaneDetectorV2``,
``adas_tpu/perception/lane_detector.py:100``, CULane variant).

Same weight and dtype handling as ``object_detector.YoloDetector``
(``compute_dtype="int8"`` is the JAX facade's ``dtype="int8"``,
``lane_detector.py:146-160``).  The multi-stream pipeline drives ``net``
directly and assembles each stream's lane points on the host with
:meth:`_assemble` / :meth:`_finalize`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.types import LaneInfo, LaneModelType

from ..models.ufld import UFLDV2_SPECS, UFLDv2Net
from ..ops.preprocess import ufld_v2_preprocess
from .object_detector import build_net, calibrate, resolve_device


class UltrafastLaneDetectorV2:
    """UFLDv2 lane detector on the port (``lane_detector.py:100``)."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_type: LaneModelType = LaneModelType.UFLDV2_CULANE,
        compute_dtype: Optional[str] = None,
        device="cuda",
        seed: int = 0,
    ):
        if model_type not in UFLDV2_SPECS:
            raise ValueError(f"UltrafastLaneDetectorV2 can't use {model_type} type.")
        self.model_type = model_type
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.spec = UFLDV2_SPECS[model_type]
        self.net = build_net(
            lambda: UFLDv2Net(self.spec, int8=compute_dtype == "int8"), self.device,
            compute_dtype, model_path, seed,
        )
        self.adjust_lanes = False
        self.lane_info = LaneInfo()

    def calibrate_int8(self, frames) -> None:
        """Static activation scales from sample BGR frames
        (``lane_detector.py:189``), preprocessed by
        :func:`ufld_v2_preprocess` in f32 (the JAX int8 net's dtype)."""
        if self.compute_dtype != "int8":
            raise ValueError("calibrate_int8 requires compute_dtype='int8'")
        s = self.spec
        calibrate(self.net, (
            ufld_v2_preprocess(f, s.input_height, s.input_width, s.crop_ratio, device=self.device)
            for f in frames
        ))

    def _assemble(self, decoded: dict, img_w: int, img_h: int) -> None:
        """Host-side point-list assembly for one frame (``decoded`` leaves
        are (R, L) / (C, L) numpy arrays; ``lane_detector.py:304``)."""
        s = self.spec
        row_x = decoded["row_x"] * img_w
        row_valid = decoded["row_valid"]
        col_y = decoded["col_y"] * img_h
        col_valid = decoded["col_valid"]
        row_anchor, col_anchor = s.row_anchor, s.col_anchor

        points = {k: [] for k in ("left-side", "left-ego", "right-ego", "right-side")}
        detected = {k: False for k in points}
        for i, key in ((1, "left-ego"), (2, "right-ego")):
            if row_valid[:, i].sum() > s.num_row / 2:
                pts = [
                    (int(row_x[k, i]), int(row_anchor[k] * img_h))
                    for k in range(s.num_row)
                    if row_valid[k, i]
                ]
                points[key].extend(pts)
                if len(pts) > 2:
                    detected[key] = True
        for i, key in ((0, "left-side"), (3, "right-side")):
            if col_valid[:, i].sum() > s.num_col / 4:
                pts = [
                    (int(col_anchor[k] * img_w), int(col_y[k, i]))
                    for k in range(s.num_col)
                    if col_valid[k, i]
                ]
                points[key].extend(pts)
                if len(pts) > 2:
                    detected[key] = True

        self.lane_info.lanes_points = np.array(list(points.values()), dtype=object)
        self.lane_info.lanes_status = list(detected.values())

    def _finalize(self, img_height: int) -> None:
        """``lane_detector.py:95``."""
        self.lane_info.update_status()
        self.lane_info.update_area(img_height, adjust_lanes=self.adjust_lanes)
