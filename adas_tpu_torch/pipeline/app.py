"""The per-frame ADAS pipeline: detect -> track -> lanes -> geometry ->
signals -> render, one frame per step (port of ``ADASPipeline``,
``adas_tpu/pipeline/app.py:59-228``), and the demo around it: ``run_video``,
``run_synthetic`` and the CLI (``python -m adas_tpu_torch.pipeline.app``).

The default route runs both nets as one fused device step with one
fetch (``pipeline/fused.py``); the unfused route detects objects, updates
the tracker, then detects lanes, one device step and fetch each.  The
tracker, distance, bird-view geometry, signals and the HUD run on the
host (the HUD with the port's cv2-free renderer, ``render/``); the
bird-view warp of the frame runs on the device every frame.  Any ported
YOLO family (v5, v8, v10) or EfficientDet serves the object side, UFLDv2
or UFLD v1 the lane side; a v1 pair runs unfused, as in JAX
(``app.py:115-119``).  Video is MP4 with MPEG-4 Part 2 (``mp4v``), as the
JAX package's cv2 writes it, or YUV4MPEG2; H.264 and H.265 (MP4, AVI or
raw) are read too, as a dash-cam records them (``render/video.py``).  Not
ported: ``display=True`` (a window: the card's host has no window
system).
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import numpy as np

from ..tracking import BYTETracker
from ..utils.logger import Logger
from ..utils.profiling import FPSCounter, StageTimers
from ..utils.types import LaneModelType, ObjectModelType

from ..analytics import PerspectiveTransformation, SingleCamDistanceMeasure, TaskConditions
from ..perception.efficientdet_detector import EfficientdetDetector
from ..perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from ..perception.object_detector import YoloDetector
from ..render.video import open_reader, open_writer, output_fps
from .fused import FusedADASStep
from .panel import ControlPanel

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

        lane_cls = (UltrafastLaneDetectorV2 if "UFLDV2" in lane_config["model_type"].name
                    else UltrafastLaneDetector)
        self.laneDetector = lane_cls(logger=self.logger, device=device, **lane_config)
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
        self.displayPanel = ControlPanel()
        self.analyzeMsg = TaskConditions()
        self.object_infer_time = 0.0
        self.lane_infer_time = 0.0
        # per-stage p50/p95 + rolling FPS
        self.timers = StageTimers()
        self.fps = FPSCounter()

        # one device step + one fetch per frame when the pair allows it
        self.fused = None
        if use_fused and isinstance(self.objectDetector, YoloDetector) \
                and isinstance(self.laneDetector, UltrafastLaneDetectorV2):
            self.fused = FusedADASStep(self.objectDetector, self.laneDetector)

    def process_frame(self, frame: np.ndarray, draw: bool = True) -> np.ndarray:
        """Run the per-frame stack on one BGR uint8 frame and return the
        annotated copy (``draw=False``: the copy unannotated; the signals
        do not depend on ``draw``)."""
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
                return self._analyze_and_render(frame_show, draw)

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
            return self._analyze_and_render(frame_show, draw)

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

    def _analyze_and_render(self, frame_show: np.ndarray, draw: bool) -> np.ndarray:
        """``app.py:170-228``: distances, the collision point, the
        bird-view re-fit, the bird-view warp of the frame (its canvas sizes
        the curvature fit and, drawn on, becomes the HUD's inset), the
        signals; then under ``draw`` the HUD onto ``frame_show``: the
        bird-view lanes, the trapezoid (at DEBUG), the lanes and their
        area, the detections, the tracks, the distances and the three
        panels."""
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
            birdview_show, *birdview_lanes[1:3], draw=draw
        )
        self.analyzeMsg.UpdateCollisionStatus(vehicle_distance, lane_info.area_status)
        self.analyzeMsg.UpdateOffsetStatus(offset)
        self.analyzeMsg.UpdateRouteStatus(direction, curvature)
        if not draw:
            return frame_show

        msg = self.analyzeMsg
        self.transformView.DrawDetectedOnBirdView(birdview_show, birdview_lanes, msg.offset_msg)
        if self.logger and self.logger.clevel == logging.DEBUG:
            self.transformView.DrawTransformFrontalViewArea(frame_show)
        self.laneDetector.DrawDetectedOnFrame(frame_show, msg.offset_msg)
        self.laneDetector.DrawAreaOnFrame(frame_show,
                                          self.displayPanel.CollisionDict[msg.collision_msg])
        self.objectDetector.DrawDetectedOnFrame(frame_show)
        if self.objectTracker is not None:
            self.objectTracker.DrawTrackedOnFrame(frame_show, False)
        self.distanceDetector.DrawDetectedOnFrame(frame_show)

        self.displayPanel.DisplayBirdViewPanel(frame_show, birdview_show)
        self.displayPanel.DisplaySignsPanel(frame_show, msg.offset_msg, msg.curvature_msg)
        self.displayPanel.DisplayCollisionPanel(
            frame_show, msg.collision_msg, self.object_infer_time, self.lane_infer_time,
        )
        return frame_show


def _no_display() -> None:
    raise NotImplementedError(
        "display=True opens a window, and the card's host has no window system: write the "
        "annotated frames to a video file instead (-o out.mp4)"
    )


def run_video(
    video_path: str,
    output_path: Optional[str] = None,
    lane_config: Optional[dict] = None,
    object_config: Optional[dict] = None,
    display: bool = False,
    max_frames: Optional[int] = None,
    device="cuda",
) -> int:
    """Process a video (``.mp4``/``.mov`` or ``.avi`` with ``mp4v``, H.264,
    H.265 or Motion JPEG, a raw ``.h264`` or ``.h265``/``.265``/``.hevc``, or
    ``.y4m``) end to end on ``device``,
    writing the annotated frames to ``output_path``: an ``.mp4`` or
    ``.avi`` at 30 fps, as the JAX package writes them, or a ``.y4m`` at the
    input's rate; returns the number of frames processed."""
    if display:
        _no_display()
    n = 0
    with open_reader(video_path) as reader:
        pipeline = ADASPipeline(
            frame_size=(reader.width, reader.height),
            lane_config=lane_config,
            object_config=object_config,
            device=device,
        )
        vout = (open_writer(output_path, reader.width, reader.height,
                            output_fps(output_path, reader.fps))
                if output_path else None)
        try:
            for frame in reader:
                frame_show = pipeline.process_frame(frame)
                if vout is not None:
                    vout.write(frame_show)
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        finally:
            if vout is not None:
                vout.close()
    return n


def run_synthetic(output_path: str, frames: int = 16, frame_hw=(720, 1280), device="cuda") -> int:
    """Headless run on seeded noise frames (``default_rng(0)``, as the JAX
    package's): the full pipeline and HUD on ``device``, the annotated
    frames written to ``output_path`` (an ``.mp4`` or a ``.y4m``) at 30 fps."""
    h, w = frame_hw
    pipeline = ADASPipeline(frame_size=(w, h), device=device)
    rng = np.random.default_rng(0)
    with open_writer(output_path, w, h, 30.0) as vout:
        for _ in range(frames):
            frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            vout.write(pipeline.process_frame(frame))
    return frames


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ADAS demo pipeline (PyTorch port)")
    ap.add_argument("-i", "--input", default=None,
                    help="input video (.mp4/.mov/.avi with mp4v, H.264, H.265 or Motion "
                         "JPEG, .h264, .h265/.265/.hevc, or .y4m)")
    ap.add_argument("-o", "--output", default=None,
                    help="output video (.mp4, .avi or .y4m; default <input>_out.mp4)")
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="run on synthetic noise frames (no input video needed)")
    ap.add_argument("--frames", type=int, default=16, help="frame count for --synthetic")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.display:
        _no_display()
    if args.synthetic:
        out = args.output or "synthetic_out.mp4"
        n = run_synthetic(out, frames=args.frames, device=args.device)
        print(f"wrote {n} frames to {out}")
        return
    if not args.input:
        ap.error("-i/--input is required unless --synthetic")
    out = args.output or args.input[:-4] + "_out.mp4"
    frames = run_video(args.input, out, max_frames=args.max_frames, device=args.device)
    print(f"wrote {frames} frames to {out}")


if __name__ == "__main__":
    main()
