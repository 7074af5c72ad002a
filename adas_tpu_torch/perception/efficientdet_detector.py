"""EfficientDet detector facade (port of ``EfficientdetDetector``,
``adas_tpu/perception/efficientdet_detector.py:26``, the native-graph
path).

Weights come from a ``params_io`` ``.npz`` or, with no ``model_path``,
from the port's seeded flax-style init, on the card unless the caller
names the CPU; the net runs in f32.  Not ported: the ONNX engine path, the zylo117 ``.pth``
import and int8 (the JAX facade's ``compute_dtype="int8"``).
:meth:`DetectFrame` is the single-frame entry point: letterbox ->
:func:`imagenet_preprocess` -> net (anchors decoded inside) -> class
max/argmax -> ``select_and_nms`` (on the GPU: the IoU and scan kernels)
-> letterbox inverse -> ``RectInfo`` rows.  The multi-stream pipeline
drives ``net`` directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.types import ObjectModelType

from ..models.efficientdet import EfficientDet, EfficientDetSpec
from ..ops.preprocess import LetterboxGeometry, imagenet_preprocess
from ..ops.yolo_decode import detections_to_original, select_and_nms
from .object_detector import ObjectDetectBase, build_net, resolve_device


def scores_and_ids(probs: torch.Tensor):
    """(B, N, C) class probabilities -> per-anchor (max score, first class
    attaining it), as ``jnp.max`` / ``jnp.argmax``."""
    return probs.amax(dim=-1), probs.argmax(dim=-1)


class EfficientdetDetector(ObjectDetectBase):
    """EfficientDet-D{0..7} on the port; ``compound`` picks the scale and
    ``input_size`` (a multiple of 128) overrides the paper's square input."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        compound: int = 0,
        input_size: Optional[int] = None,
        box_score: float = 0.6,
        box_nms_iou: float = 0.5,
        max_det: int = 100,
        classes_path: Optional[str] = None,
        device="cuda",
        seed: int = 0,
    ):
        self.model_type = ObjectModelType.EfficientDet
        self.box_score = box_score
        self.box_nms_iou = box_nms_iou
        self.max_det = max_det
        self.device = resolve_device(device)
        self._initialize_class(classes_path)
        self.spec = EfficientDetSpec(
            compound=int(compound), num_classes=len(self.class_names),
            input_size_override=input_size,
        )
        self.net = build_net(lambda: EfficientDet(self.spec), self.device, None, model_path, seed)

    @torch.inference_mode()
    def detect(self, frame_bgr: np.ndarray) -> torch.Tensor:
        """One BGR uint8 frame -> (1, max_det, 6) detection rows in source
        coordinates, on the device (``efficientdet_detector.py:152``)."""
        s = self.spec.input_size
        geom = LetterboxGeometry(frame_bgr.shape[0], frame_bgr.shape[1], s, s)
        boxes, probs = self.net(imagenet_preprocess(frame_bgr, geom, device=self.device))
        scores, ids = scores_and_ids(probs)
        dets = select_and_nms(
            boxes, scores, ids, box_score=float(self.box_score),
            iou_threshold=float(self.box_nms_iou), max_det=int(self.max_det),
        )
        return detections_to_original(dets, geom)

    def DetectFrame(self, srcimg: np.ndarray) -> None:
        """Detect on one BGR frame; the result is :attr:`object_info`."""
        self._object_info = self._dets_to_rectinfo(self.detect(srcimg)[0].cpu().numpy())
