"""Multi-stream ADAS: N video feeds through ONE batched device step (port of
``MultiStreamADAS``, ``adas_tpu/pipeline/multistream.py:105``, with I420
transport on one GPU and no mesh).

Per tick: the host encodes each BGR frame to I420 and uploads the batch;
one device step runs the YUV-direct preprocess, the YOLO net + decode + NMS
(or a YOLOv10's one-to-one head and its top-k with ``nms_free``,
``multistream.py:311-316``) + letterbox inverse and UFLDv2 + lane decode
for all streams at once (the
JAX step's ``vmap`` over streams is the batch dimension here) and packs
the results into one tensor; the host fetches it in one copy and runs
ByteTrack, distance and TaskConditions per stream.  All cross-frame state
is host-side per stream.  Under int8 (both facades with
``compute_dtype="int8"``, calibrated) both nets take bf16 input from the
YUV-direct preprocess (``multistream.py:190-205``).  The YUV-direct
preprocess serves a YOLOv8 or v10, whose JAX stems take its planes; for
the other YOLO families the step decodes the I420 batch into rounded BGR
planes once and feeds both nets from them (``multistream.py:257-285``;
the net's ``stem_takes_planes`` decides).  The object side may instead be an
``EfficientdetDetector`` (``multistream.py:164-181, 271-310``): then the
step decodes the planes as well, letterboxes them square and
ImageNet-normalizes them for the net (boxes and class probabilities,
anchors decoded inside), runs ``select_and_nms`` on the class
max/argmax, and feeds the lane net from the same planes.  Not ported: the bgr transport, the tunnel's
``host_downscale`` ladder, the compute probe and the step artifacts.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..tracking import BYTETracker
from ..utils.types import LaneInfo

from ..analytics import PerspectiveTransformation, SingleCamDistanceMeasure, TaskConditions
from ..ops.packing import unpack
from ..ops.preprocess import bgr_to_i420
from .fused import fused_step, letterbox_geometry


class StreamState:
    """Host-side temporal state for one video feed (``multistream.py:52``)."""

    def __init__(self, frame_size, colors_dict, device):
        self.tracker = BYTETracker(names=dict(colors_dict))
        self.distance = SingleCamDistanceMeasure()
        self.conditions = TaskConditions()
        self.perspective = PerspectiveTransformation(frame_size, device=device)
        self.lane_info = LaneInfo()


class MultiStreamADAS:
    """Batch-of-streams pipeline on one device; ``yolo`` is the object
    side, a ``YoloDetector`` or an ``EfficientdetDetector``."""

    def __init__(
        self,
        yolo,
        lane,
        n_streams: int,
        frame_hw: Sequence[int],
        transport: str = "i420",
    ):
        if transport != "i420":
            raise ValueError(f"the port serves the i420 transport only, got {transport!r}")
        if yolo.device != lane.device:
            raise ValueError(f"detectors on {yolo.device} and {lane.device}")
        self.yolo = yolo
        self.lane = lane
        self.n_streams = n_streams
        self.frame_hw = tuple(frame_hw)
        self.transport = transport
        self.device = yolo.device
        h, w = self.frame_hw
        self.geom = letterbox_geometry(yolo, self.frame_hw)
        self.streams = [StreamState((w, h), yolo.colors_dict, self.device) for _ in range(n_streams)]
        # calcCurveAndOffset reads only the canvas shape
        self._canvas = np.zeros((h, w, 3), np.uint8)
        self._pack_spec = None
        self._prep_pool = None
        self._uploader = None
        self._fetcher = None

    # ---- device step ----

    def _step(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H*3/2, W) uint8 I420 on the device -> (B, total) f32 packed
        detections + decoded lanes (``multistream.py:248-362``), through
        the fused step of ``pipeline/fused.py``."""
        flat, self._pack_spec = fused_step(self.yolo, self.lane, x, self.frame_hw, "i420",
                                           nms_free=bool(getattr(self.yolo, "nms_free", False)))
        return flat

    # ---- host orchestration ----

    def _host_prep(self, frames: np.ndarray) -> np.ndarray:
        """BGR (N, H, W, 3) uint8 -> I420 (N, H*3/2, W), fanned out over a
        small thread pool (numpy releases the GIL in the big array ops)."""
        if self._prep_pool is None:
            self._prep_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="adas-prep")
        return np.stack(list(self._prep_pool.map(bgr_to_i420, frames)))

    def _prep_upload(self, frames: np.ndarray) -> torch.Tensor:
        """Host prep + upload; returns the device-resident input batch."""
        if frames.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} frames, got {frames.shape[0]}")
        return torch.from_numpy(self._host_prep(frames)).to(self.device)

    def prefetch(self, frames: np.ndarray):
        """Host prep + upload on a background thread; returns a Future
        whose result goes to :meth:`submit_device`."""
        if self._uploader is None:
            self._uploader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="adas-upload")
        return self._uploader.submit(self._prep_upload, frames)

    def submit_device(self, x: torch.Tensor) -> torch.Tensor:
        """Launch the device step on an uploaded batch (asynchronous on a
        GPU: the returned tensor is ready when :meth:`fetch` copies it)."""
        return self._step(x)

    def submit(self, frames: np.ndarray) -> torch.Tensor:
        """frames: (n_streams, H, W, 3) uint8 BGR."""
        return self._step(self._prep_upload(frames))

    def fetch(self, handle: torch.Tensor, frames: np.ndarray) -> List[dict]:
        """One device->host copy of the packed outputs, then per-stream
        host analytics; returns the signal dicts."""
        return self._analytics(handle.cpu().numpy(), frames)

    def _analytics(self, flat: np.ndarray, frames: np.ndarray) -> List[dict]:
        """Host analytics per stream (``multistream.py:470-545``)."""
        h, w = self.frame_hw
        results = []
        for i, stream in enumerate(self.streams):
            dets, lanes_i = unpack(flat[i], self._pack_spec)
            objs = self.yolo._dets_to_rectinfo(dets)
            # point the (stateless-compute) lane facade at THIS stream's
            # holder so geometry never bleeds across feeds
            self.lane.lane_info = stream.lane_info
            self.lane._assemble(lanes_i, w, h)
            self.lane._finalize(h)
            lane_info = stream.lane_info

            boxes = [o.tolist(format_type="xyxy") for o in objs]
            stream.tracker.update(
                np.asarray(boxes, dtype=np.float64).reshape(-1, 4),
                np.asarray([o.conf for o in objs], dtype=np.float64),
                [o.label for o in objs],
                frames[i],
            )
            stream.distance.updateDistance(objs)
            collision_pt = stream.distance.calcCollisionPoint(lane_info.area_points)
            if stream.conditions.CheckStatus() and lane_info.area_status:
                stream.perspective.updateTransformParams(
                    *lane_info.lanes_points[1:3], stream.conditions.transform_status,
                )
            bird_lanes = [
                stream.perspective.transformToBirdViewPoints(p)
                for p in lane_info.lanes_points
            ]
            (direction, curvature), offset = stream.perspective.calcCurveAndOffset(
                self._canvas, *bird_lanes[1:3], draw=False
            )
            stream.conditions.UpdateCollisionStatus(collision_pt, lane_info.area_status)
            stream.conditions.UpdateOffsetStatus(offset)
            stream.conditions.UpdateRouteStatus(direction, curvature)
            results.append(
                {
                    "objects": objs,
                    "tracks": len(stream.tracker.tracked_stracks),
                    "collision": stream.conditions.collision_msg,
                    "offset": stream.conditions.offset_msg,
                    "curvature": stream.conditions.curvature_msg,
                    "lane_info": lane_info,
                    "lanes_points": lane_info.lanes_points,
                    "lanes_status": lane_info.lanes_status,
                    "area_status": lane_info.area_status,
                }
            )
        return results

    def process_batch(self, frames: np.ndarray) -> List[dict]:
        return self.fetch(self.submit(frames), frames)

    def serve_pipelined(self, batches, depth: int = 3, on_result=None) -> int:
        """Three-stage software pipeline over a tick iterator
        (``multistream.py:642``): stage 1 (upload thread) host prep +
        upload, stage 2 (caller thread) launches the device step, stage 3
        (fetch thread) copies the packed outputs back and runs the
        per-stream analytics, IN ORDER on one worker so tracker and
        condition state advance in tick order.

        ``batches``: iterable of (n_streams, H, W, 3) uint8 ticks.
        ``depth``: max un-fetched device batches.
        ``on_result(tick_index, signals)``: optional, called on the fetch
        thread in order.  Returns the number of ticks."""
        if self._fetcher is None:
            self._fetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="adas-fetch")

        def fetch_and_report(idx, handle, frames):
            out = self.fetch(handle, frames)
            if on_result is not None:
                on_result(idx, out)

        pending = deque()  # (idx, frames, Future[device batch])
        fetches = deque()  # Futures from the fetch worker
        n = 0
        for idx, frames in enumerate(batches):
            n = idx + 1
            pending.append((idx, frames, self.prefetch(frames)))
            if len(pending) >= 2:
                i, f, fut = pending.popleft()
                h = self.submit_device(fut.result())
                fetches.append(self._fetcher.submit(fetch_and_report, i, h, f))
            while len(fetches) > depth:
                fetches.popleft().result()
        while pending:
            i, f, fut = pending.popleft()
            h = self.submit_device(fut.result())
            fetches.append(self._fetcher.submit(fetch_and_report, i, h, f))
        while fetches:
            fetches.popleft().result()
        return n

    def close(self) -> None:
        """Stop the pipeline's worker threads."""
        for pool in (self._prep_pool, self._uploader, self._fetcher):
            if pool is not None:
                pool.shutdown(wait=True)
        self._prep_pool = self._uploader = self._fetcher = None
