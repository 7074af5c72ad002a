"""UFLDv2 lane detector facade (port of ``UltrafastLaneDetectorV2``,
``adas_tpu/perception/lane_detector.py:100``, CULane and TuSimple).

Same weight and dtype handling as ``object_detector.YoloDetector``
(``compute_dtype="int8"`` is the JAX facade's ``dtype="int8"``,
``lane_detector.py:146-160``).  :meth:`UltrafastLaneDetectorV2.DetectFrame`
is the single-frame entry point: preprocess -> net -> ``ufld_v2_decode``
-> ``pack`` on the device, one fetch, then the point assembly on the
host.  The multi-stream pipeline drives ``net`` directly and assembles
each stream's lane points with :meth:`_assemble` / :meth:`_finalize`.
Not ported: UFLD v1, CurveLanes, the ONNX and ``.adas`` engines and the
cv2 drawing (``ROADMAP.md`` §1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.types import LaneInfo, LaneModelType

from ..models.ufld import UFLDV2_SPECS, UFLDv2Net
from ..ops.packing import pack, unpack
from ..ops.preprocess import frame_to_device, ufld_v2_preprocess
from ..ops.ufld_decode import ufld_v2_decode
from .object_detector import build_net, calibrate, resolve_device


class LaneDetectBase:
    """Options and lane state shared by the lane detectors
    (``lane_detector.py:33``)."""

    _defaults = {"model_path": None, "model_type": None}

    @classmethod
    def set_defaults(cls, config: dict) -> None:
        cls._defaults = config

    @classmethod
    def check_defaults(cls) -> dict:
        return cls._defaults

    @classmethod
    def get_defaults(cls, name: str):
        if name in cls._defaults:
            return cls._defaults[name]
        return f"Unrecognized attribute name '{name}'"

    def __init__(self, logger=None):
        self.__dict__.update(self._defaults)
        self.logger = logger
        self.adjust_lanes = False
        self.lane_info = LaneInfo()

    def _finalize(self, img_height: int) -> None:
        """``lane_detector.py:95``."""
        self.lane_info.update_status()
        self.lane_info.update_area(img_height, adjust_lanes=self.adjust_lanes)


class UltrafastLaneDetectorV2(LaneDetectBase):
    """UFLDv2 lane detector on the port (``lane_detector.py:100``): the
    class's ``_defaults`` give ``model_path`` and ``model_type`` where the
    caller passes None; ``compute_dtype`` None (f32), ``"bf16"`` or
    ``"int8"``."""

    _defaults = {"model_path": None, "model_type": LaneModelType.UFLDV2_CULANE}

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_type: Optional[LaneModelType] = None,
        compute_dtype: Optional[str] = None,
        logger=None,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__(logger)
        if model_path is not None:
            self.model_path = model_path
        if model_type is not None:
            self.model_type = model_type
        if self.model_type not in UFLDV2_SPECS:
            msg = f"UltrafastLaneDetectorV2 can't use {self.model_type} type."
            if self.logger:
                self.logger.error(msg)
            raise ValueError(msg)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.spec = UFLDV2_SPECS[self.model_type]
        self.net = build_net(
            lambda: UFLDv2Net(self.spec, int8=compute_dtype == "int8"), self.device,
            compute_dtype, self.model_path, seed,
        )
        if self.logger:
            self.logger.info(
                f"UfldDetectorV2 [{self.model_type.name}] input "
                f"{self.spec.input_height}x{self.spec.input_width} torch {self.device}"
            )

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

    @torch.inference_mode()
    def _step(self, frame: torch.Tensor):
        """(H, W, 3) uint8 BGR on the device -> the decoded lane tensors
        packed into one (1, total) f32 tensor, and the pack spec
        (``lane_detector.py:211``).  The net's input is bf16 for a bf16
        net, else f32 (an int8 net's, as the JAX facade feeds it)."""
        s = self.spec
        in_dtype = torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32
        x = ufld_v2_preprocess(
            frame, s.input_height, s.input_width, s.crop_ratio, dtype=in_dtype, device=self.device,
        )
        outputs = {k: v.float() for k, v in self.net(x).items()}
        return pack(ufld_v2_decode(outputs))

    def DetectFrame(self, image: np.ndarray, adjust_lanes: bool = False) -> None:
        """Detect lanes on one BGR uint8 frame; the result is
        :attr:`lane_info` (``lane_detector.py:269``)."""
        h, w = image.shape[:2]
        flat, spec = self._step(frame_to_device(image, self.device))
        decoded = unpack(flat.cpu().numpy()[0], spec)
        self.adjust_lanes = adjust_lanes
        self._assemble(decoded, w, h)
        self._finalize(h)

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
