"""Fused per-frame device step: object detection + lane detection in ONE
device step with one packed fetch, and async submit/fetch (port of
``FusedADASStep``, ``adas_tpu/pipeline/fused.py:44``).

:func:`fused_step` is the device step both pipelines run: this module's
:class:`FusedADASStep` on one frame, ``MultiStreamADAS`` on a batch of
streams.  Transports: ``"bgr"`` uploads the uint8 frame, ``"i420"``
uploads its 4:2:0 planes (half the bytes) and, as JAX does
(``fused.py:143-217``), preprocesses them YUV-direct
(``yolo_preprocess_yuv`` / ``ufld_v2_preprocess_yuv``, the counterpart of
the JAX planes path) when the object net's stem takes planes (its
``stem_takes_planes``, set by YOLOv8 and v10 as JAX's ``stem_s2d_ok``);
any other object side (EfficientDet, YOLOv5,
v5-lite, v6, v7, v9) decodes the planes to rounded BGR once and feeds both
nets from them.  ``host_downscale`` resizes a larger frame on the
host before the upload (``render/draw.resize_linear``, cv2's
``INTER_LINEAR`` to the bit) and scales the detections back.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.types import ObjectModelType

from ..ops.packing import pack, unpack
from ..ops.preprocess import (
    LetterboxGeometry,
    bgr_to_i420,
    frame_to_device,
    i420_to_bgr_planar,
    imagenet_preprocess,
    imagenet_preprocess_planar,
    ufld_v2_preprocess,
    ufld_v2_preprocess_planar,
    ufld_v2_preprocess_yuv,
    yolo_preprocess,
    yolo_preprocess_planar,
    yolo_preprocess_yuv,
)
from ..ops.ufld_decode import ufld_v2_decode
from ..render.draw import resize_linear
from ..ops.yolo_decode import detections_to_original, select_and_nms
from ..perception.efficientdet_detector import scores_and_ids
from ..perception.object_detector import input_torch_dtype


def letterbox_geometry(yolo, frame_hw: Sequence[int]) -> LetterboxGeometry:
    """The object net's letterbox for ``frame_hw`` source frames
    (EfficientDet's input is square)."""
    s = yolo.spec.input_size
    if yolo.model_type is ObjectModelType.EfficientDet:
        s = (s, s)
    return LetterboxGeometry(frame_hw[0], frame_hw[1], *s)


@torch.inference_mode()
def fused_step(yolo, lane, x: torch.Tensor, frame_hw: Sequence[int], transport: str,
               nms_free: bool = False):
    """One device step over a batch of frames: ``x`` is (B, H*3/2, W) uint8
    I420 (``transport="i420"``) or (B, H, W, 3) uint8 BGR (``"bgr"``) on
    the device -> ((B, total) f32 packed detections + decoded lanes, pack
    spec; per stream the (max_det, 6) rows and the lanes (1, R, L)) (``fused.py:141-227``, ``multistream.py:248-362``).  The YOLO
    detections come from ``yolo.detections``: decode + NMS, or with
    ``nms_free`` (a YOLOv10's) the one-to-one head's top-k
    (``multistream.py:311-316``).

    Input dtypes as ``fused.py:101-110`` sets them: the YOLO net takes bf16
    under bf16 and int8; the lane net takes bf16 under bf16 and, on I420,
    under int8 too (f32 under int8 from BGR, as the JAX step feeds it)."""
    xo, lx = fused_inputs(yolo, lane, x, frame_hw, transport)
    return fused_outputs(yolo, lane, xo, lx, frame_hw, nms_free)


def fused_inputs(yolo, lane, x: torch.Tensor, frame_hw: Sequence[int], transport: str):
    """The first half of :func:`fused_step`: the transport batch -> the
    object net's and the lane net's input batches."""
    h, w = frame_hw
    lspec = lane.spec
    geom = letterbox_geometry(yolo, frame_hw)
    is_effdet = yolo.model_type is ObjectModelType.EfficientDet
    lane_crop = (lspec.input_height, lspec.input_width, lspec.crop_ratio)
    if transport == "i420":
        lane_dtype = input_torch_dtype(lane.compute_dtype)
    else:
        lane_dtype = torch.bfloat16 if lane.compute_dtype == "bf16" else torch.float32
    if transport == "i420" and not getattr(yolo.net, "stem_takes_planes", False):
        # the full-resolution decode keeps cv2's round/clip; both nets
        # read its planes (multistream.py:271-275, 334-343)
        bgr = i420_to_bgr_planar(x, h, w)
        if is_effdet:
            xo = imagenet_preprocess_planar(bgr, geom)
        else:
            xo = yolo_preprocess_planar(bgr, geom, dtype=input_torch_dtype(yolo.compute_dtype))
        lx = ufld_v2_preprocess_planar(bgr, *lane_crop, dtype=lane_dtype)
    elif transport == "i420":
        xo = yolo_preprocess_yuv(x, h, w, geom, dtype=input_torch_dtype(yolo.compute_dtype))
        lx = ufld_v2_preprocess_yuv(x, h, w, *lane_crop, dtype=lane_dtype)
    elif transport == "bgr":
        if is_effdet:
            xo = imagenet_preprocess(x, geom, device=x.device)
        else:
            xo = yolo_preprocess(
                x, geom, dtype=input_torch_dtype(yolo.compute_dtype), device=x.device
            )
        lx = ufld_v2_preprocess(x, *lane_crop, dtype=lane_dtype, device=x.device)
    else:
        raise ValueError(f"transport must be 'bgr' or 'i420', got {transport!r}")
    return xo, lx


def fused_outputs(yolo, lane, xo: torch.Tensor, lx: torch.Tensor, frame_hw: Sequence[int],
                  nms_free: bool = False):
    """The second half of :func:`fused_step`: both nets on their input
    batches, the decode and the NMS -> (packed flat outputs, pack spec)."""
    geom = letterbox_geometry(yolo, frame_hw)
    if yolo.model_type is ObjectModelType.EfficientDet:
        boxes, probs = yolo.net(xo)
        scores, ids = scores_and_ids(probs)
        dets = select_and_nms(
            boxes, scores, ids, box_score=float(yolo.box_score),
            iou_threshold=float(yolo.box_nms_iou), max_det=int(yolo.max_det),
        )
    else:
        dets = yolo.detections(xo, nms_free)
    dets = detections_to_original(dets, geom)
    louts = {k: v.float() for k, v in lane.net(lx).items()}
    # each stream's lanes as (1, R, L), as JAX's per-frame step packs them
    lanes = {k: v[:, None] for k, v in ufld_v2_decode(louts).items()}
    return pack((dets, lanes))


class FusedADASStep:
    """Runs a ``YoloDetector`` (or ``EfficientdetDetector``) and an
    ``UltrafastLaneDetectorV2`` as one device step on their device.

    ``submit(frame)`` uploads the frame and launches the step (on a GPU it
    returns before the device finishes); ``fetch(handle)`` copies the one
    packed result back, then populates both detectors' result state
    (``object_info`` / ``lane_info``) exactly as their own ``DetectFrame``
    would.  A YOLOv10 runs its one-to-many head and NMS here whatever its
    ``nms_free``, as the JAX step does (``fused.py:185-200`` takes no
    NMS-free branch)."""

    def __init__(self, yolo, lane, host_downscale=None, transport: str = "bgr"):
        if transport not in ("bgr", "i420"):
            raise ValueError(f"transport must be 'bgr' or 'i420', got {transport!r}")
        if yolo.device != lane.device:
            raise ValueError(f"detectors on {yolo.device} and {lane.device}")
        self.yolo = yolo
        self.lane = lane
        self.host_downscale = host_downscale
        self.transport = transport
        self.device = yolo.device

    def submit(self, frame: np.ndarray) -> Tuple[torch.Tensor, object, Tuple[int, int],
                                                 Tuple[int, int]]:
        """Upload one BGR uint8 frame (resized on the host first when it is
        larger than ``host_downscale`` (H, W)) and launch the fused step;
        returns an opaque handle for :meth:`fetch`."""
        orig_shape = frame.shape[:2]
        if self.host_downscale and (orig_shape[0] > self.host_downscale[0]
                                    or orig_shape[1] > self.host_downscale[1]):
            dh, dw = self.host_downscale
            frame = resize_linear(frame, (dw, dh))
        src_shape = frame.shape[:2]
        payload = bgr_to_i420(frame) if self.transport == "i420" else frame
        x = frame_to_device(payload, self.device)[None]
        flat, spec = fused_step(self.yolo, self.lane, x, src_shape, self.transport)
        return flat, spec, src_shape, orig_shape

    def fetch(self, handle) -> None:
        """Copy the step's result to the host and populate both detectors
        (detections scaled from a downscaled frame back to the source's
        pixels; the lanes are normalized and rescale in ``_assemble``)."""
        flat, spec, src_shape, (h, w) = handle
        dets, decoded = unpack(flat.cpu().numpy()[0], spec)
        if src_shape != (h, w):
            dets = dets.copy()
            dets[:, [0, 2]] *= w / src_shape[1]
            dets[:, [1, 3]] *= h / src_shape[0]
        self.yolo._object_info = self.yolo._dets_to_rectinfo(dets)
        self.lane._assemble({k: v[0] for k, v in decoded.items()}, w, h)
        self.lane._finalize(h)

    def run(self, frame: np.ndarray) -> None:
        """Synchronous convenience: submit + fetch."""
        self.fetch(self.submit(frame))
