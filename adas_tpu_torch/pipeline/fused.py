"""Fused per-frame device step: object detection + lane detection in ONE
device step with one packed fetch, and async submit/fetch (port of
``FusedADASStep``, ``adas_tpu/pipeline/fused.py:44``).

:func:`fused_step` is the device step both pipelines run: this module's
:class:`FusedADASStep` on one frame, ``MultiStreamADAS`` on a batch of
streams.  Transports: ``"bgr"`` uploads the uint8 frame, ``"i420"``
uploads its 4:2:0 planes (half the bytes) and preprocesses them
YUV-direct (``yolo_preprocess_yuv`` / ``ufld_v2_preprocess_yuv``, the
counterpart of the JAX planes path); an EfficientDet object side decodes
the planes to rounded BGR once and feeds both nets from them
(``fused.py:180-201``).  Not ported: ``host_downscale``, the host
pre-resize, which needs a cv2-free host resize (``ROADMAP.md`` §1).
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
    yolo_preprocess_yuv,
)
from ..ops.ufld_decode import ufld_v2_decode
from ..ops.yolo_decode import decode_predictions, detections_to_original, select_and_nms
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
def fused_step(yolo, lane, x: torch.Tensor, frame_hw: Sequence[int], transport: str):
    """One device step over a batch of frames: ``x`` is (B, H*3/2, W) uint8
    I420 (``transport="i420"``) or (B, H, W, 3) uint8 BGR (``"bgr"``) on
    the device -> ((B, total) f32 packed detections + decoded lanes, pack
    spec) (``fused.py:141-227``, ``multistream.py:248-362``).

    Input dtypes as ``fused.py:101-110`` sets them: the YOLO net takes bf16
    under bf16 and int8; the lane net takes bf16 under bf16 and, on I420,
    under int8 too (f32 under int8 from BGR, as the JAX step feeds it)."""
    h, w = frame_hw
    lspec = lane.spec
    geom = letterbox_geometry(yolo, frame_hw)
    is_effdet = yolo.model_type is ObjectModelType.EfficientDet
    lane_crop = (lspec.input_height, lspec.input_width, lspec.crop_ratio)
    if transport == "i420":
        lane_dtype = input_torch_dtype(lane.compute_dtype)
    else:
        lane_dtype = torch.bfloat16 if lane.compute_dtype == "bf16" else torch.float32
    if transport == "i420" and is_effdet:
        # the full-resolution decode keeps cv2's round/clip; both nets
        # read its planes (multistream.py:271-275, 334-343)
        bgr = i420_to_bgr_planar(x, h, w)
        xo = imagenet_preprocess_planar(bgr, geom)
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
    if is_effdet:
        boxes, probs = yolo.net(xo)
        scores, ids = scores_and_ids(probs)
    else:
        boxes, scores, ids = decode_predictions(yolo.net(xo).float())
    dets = select_and_nms(
        boxes, scores, ids, box_score=float(yolo.box_score),
        iou_threshold=float(yolo.box_nms_iou), max_det=int(yolo.max_det),
    )
    dets = detections_to_original(dets, geom)
    louts = {k: v.float() for k, v in lane.net(lx).items()}
    return pack((dets, ufld_v2_decode(louts)))


class FusedADASStep:
    """Runs a ``YoloDetector`` (or ``EfficientdetDetector``) and an
    ``UltrafastLaneDetectorV2`` as one device step on their device.

    ``submit(frame)`` uploads the frame and launches the step (on a GPU it
    returns before the device finishes); ``fetch(handle)`` copies the one
    packed result back, then populates both detectors' result state
    (``object_info`` / ``lane_info``) exactly as their own ``DetectFrame``
    would."""

    def __init__(self, yolo, lane, host_downscale=None, transport: str = "bgr"):
        if host_downscale:
            raise NotImplementedError(
                "host_downscale resizes on the host with cv2, which the port does not have "
                "(ROADMAP.md §1, host_downscale)"
            )
        if transport not in ("bgr", "i420"):
            raise ValueError(f"transport must be 'bgr' or 'i420', got {transport!r}")
        if yolo.device != lane.device:
            raise ValueError(f"detectors on {yolo.device} and {lane.device}")
        self.yolo = yolo
        self.lane = lane
        self.transport = transport
        self.device = yolo.device

    def submit(self, frame: np.ndarray) -> Tuple[torch.Tensor, object, Tuple[int, int]]:
        """Upload one BGR uint8 frame and launch the fused step; returns an
        opaque handle for :meth:`fetch`."""
        src_shape = frame.shape[:2]
        payload = bgr_to_i420(frame) if self.transport == "i420" else frame
        x = frame_to_device(payload, self.device)[None]
        flat, spec = fused_step(self.yolo, self.lane, x, src_shape, self.transport)
        return flat, spec, src_shape

    def fetch(self, handle) -> None:
        """Copy the step's result to the host and populate both detectors."""
        flat, spec, (h, w) = handle
        dets, decoded = unpack(flat.cpu().numpy()[0], spec)
        self.yolo._object_info = self.yolo._dets_to_rectinfo(dets)
        self.lane._assemble(decoded, w, h)
        self.lane._finalize(h)

    def run(self, frame: np.ndarray) -> None:
        """Synchronous convenience: submit + fetch."""
        self.fetch(self.submit(frame))
