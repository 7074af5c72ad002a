"""The per-frame ADAS pipeline: detect -> track -> lanes -> geometry ->
signals, one frame per step (port of ``ADASPipeline``,
``adas_tpu/pipeline/app.py:59-215``).

The default route runs both nets as one fused device step with one
fetch (``pipeline/fused.py``); the unfused route detects objects, updates
the tracker, then detects lanes, one device step and fetch each.  The
tracker, distance, bird-view geometry and signals run on the host; the
bird-view warp of the frame runs on the device every frame.  Not ported:
rendering (``draw=True``, the control panel, every ``Draw*`` call) and
video I/O (``run_video``), which wait for a cv2-free renderer
(``ROADMAP.md`` §1); UFLD v1 lane models.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from ..tracking import BYTETracker
from ..utils.logger import Logger
from ..utils.profiling import FPSCounter, StageTimers
from ..utils.types import LaneModelType, ObjectModelType

from ..analytics import PerspectiveTransformation, SingleCamDistanceMeasure, TaskConditions
from ..analytics.perspective import NO_RENDERER
from ..perception.efficientdet_detector import EfficientdetDetector
from ..perception.lane_detector import UltrafastLaneDetectorV2
from ..perception.object_detector import YoloDetector
from .fused import FusedADASStep

DEFAULT_LANE_CONFIG = {
    "model_path": None,
    "model_type": LaneModelType.UFLDV2_CULANE,
}
DEFAULT_OBJECT_CONFIG = {
    "model_path": None,
    "model_type": ObjectModelType.YOLOV8,
    "classes_path": None,
    "box_score": 0.4,
    "box_nms_iou": 0.5,
}


class ADASPipeline:
    """Wires every layer together and processes frames one at a time, on
    ``device`` (the card unless the caller names the CPU).

    ``lane_config`` / ``object_config`` update ``DEFAULT_*_CONFIG`` and go
    to the facades as keywords (``compute_dtype`` selects bf16 or int8 on
    either; an int8 pair needs ``calibrate_int8`` on both detectors
    before it serves)."""

    def __init__(
        self,
        frame_size=(1280, 720),
        lane_config: Optional[dict] = None,
        object_config: Optional[dict] = None,
        logger: Optional[Logger] = None,
        enable_tracker: bool = True,
        use_fused: bool = True,
        device="cuda",
    ):
        self.logger = logger or Logger(None, logging.INFO, logging.INFO)
        lane_config = {**DEFAULT_LANE_CONFIG, **(lane_config or {})}
        object_config = {**DEFAULT_OBJECT_CONFIG, **(object_config or {})}

        if "UFLDV2" not in lane_config["model_type"].name:
            raise NotImplementedError(
                f"{lane_config['model_type'].name}: UFLD v1 is not ported (ROADMAP.md §1)"
            )
        self.laneDetector = UltrafastLaneDetectorV2(
            logger=self.logger, device=device, **lane_config
        )
        self.transformView = PerspectiveTransformation(
            frame_size, logger=self.logger, device=device
        )
        if object_config["model_type"] == ObjectModelType.EfficientDet:
            self.objectDetector = EfficientdetDetector(
                logger=self.logger, device=device, **object_config
            )
        else:
            self.objectDetector = YoloDetector(logger=self.logger, device=device, **object_config)
        self.distanceDetector = SingleCamDistanceMeasure()
        self.objectTracker = (
            BYTETracker(names=self.objectDetector.colors_dict) if enable_tracker else None
        )
        self.analyzeMsg = TaskConditions()
        self.object_infer_time = 0.0
        self.lane_infer_time = 0.0
        # per-stage p50/p95 + rolling FPS
        self.timers = StageTimers()
        self.fps = FPSCounter()

        # one device step + one fetch per frame when the pair allows it
        self.fused = None
        if use_fused and isinstance(self.objectDetector, YoloDetector):
            self.fused = FusedADASStep(self.objectDetector, self.laneDetector)

    def process_frame(self, frame: np.ndarray, draw: bool = True) -> np.ndarray:
        """Run the per-frame stack on one BGR uint8 frame and return the
        frame.  ``draw=True`` (the JAX default, which renders the HUD onto
        the returned frame) raises ``NotImplementedError``: pass
        ``draw=False``, which returns an unannotated copy."""
        if draw:
            raise NotImplementedError(NO_RENDERER)
        frame_show = frame.copy()

        self.fps.tick()
        if self.fused is not None:
            t0 = time.time()
            with self.timers.stage("fused_infer"):
                self.fused.run(frame)
            self.object_infer_time = round(time.time() - t0, 2)
            self.lane_infer_time = self.object_infer_time
            with self.timers.stage("tracker"):
                self._update_tracker(frame)
            with self.timers.stage("analytics_render"):
                return self._analyze(frame_show)

        t0 = time.time()
        with self.timers.stage("object_infer"):
            self.objectDetector.DetectFrame(frame)
        self.object_infer_time = round(time.time() - t0, 2)

        with self.timers.stage("tracker"):
            self._update_tracker(frame)

        t0 = time.time()
        with self.timers.stage("lane_infer"):
            self.laneDetector.DetectFrame(frame)
        self.lane_infer_time = round(time.time() - t0, 4)
        with self.timers.stage("analytics_render"):
            return self._analyze(frame_show)

    def _update_tracker(self, frame: np.ndarray) -> None:
        if self.objectTracker is None:
            return
        objs = self.objectDetector.object_info
        self.objectTracker.update(
            np.asarray([o.tolist(format_type="xyxy") for o in objs], dtype=np.float64).reshape(-1, 4),
            np.asarray([o.conf for o in objs], dtype=np.float64),
            [o.label for o in objs],
            frame,
        )

    def _analyze(self, frame_show: np.ndarray) -> np.ndarray:
        """The analytics half of ``_analyze_and_render`` (``app.py:171-198``):
        distances, the collision point, the bird-view re-fit, the bird-view
        warp of the frame (its canvas sizes the curvature fit) and the
        signals.  Returns ``frame_show`` as it came."""
        self.distanceDetector.updateDistance(self.objectDetector.object_info)
        lane_info = self.laneDetector.lane_info
        vehicle_distance = self.distanceDetector.calcCollisionPoint(lane_info.area_points)
        if self.analyzeMsg.CheckStatus() and lane_info.area_status:
            self.transformView.updateTransformParams(
                *lane_info.lanes_points[1:3], self.analyzeMsg.transform_status,
            )
        birdview_show = self.transformView.transformToBirdView(frame_show)
        birdview_lanes = [
            self.transformView.transformToBirdViewPoints(pts) for pts in lane_info.lanes_points
        ]
        (direction, curvature), offset = self.transformView.calcCurveAndOffset(
            birdview_show, *birdview_lanes[1:3], draw=False
        )
        self.analyzeMsg.UpdateCollisionStatus(vehicle_distance, lane_info.area_status)
        self.analyzeMsg.UpdateOffsetStatus(offset)
        self.analyzeMsg.UpdateRouteStatus(direction, curvature)
        return frame_show
