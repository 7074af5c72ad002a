"""EfficientDet detector facade (port of ``EfficientdetDetector``,
``adas_tpu/perception/efficientdet_detector.py:26``, the native-graph
path).

Weights come from a zylo117 ``.pth``/``.pt`` release
(``tools/efficientdet_import``; the head's class count is the
checkpoint's, 90 for the released weights: ``efficientdet_detector.py:55-77``),
a ``params_io`` ``.npz`` or an ``_int8.npz`` store, or, with no
``model_path``, from the port's seeded flax-style init, on the card
unless the caller names the CPU.  ``compute_dtype`` is None (f32) or ``"int8"``
(``efficientdet_detector.py:40-42``): the int8 graph of
``models/efficientdet.py``, its W8A8 kernels packed at load and static
activation scales from :meth:`EfficientdetDetector.calibrate_int8`
(``:116-160``).  An ``.onnx`` model_path is the reference's
postprocessed export (boxes, class ids, scores): it runs on the ONNX graph
engine (``engine/onnx_engine.OnnxGraphEngine``, ``:55-58``), as does an
injected ``engine``: letterbox, BGR ImageNet normalization, the graph,
the letterbox inverse and the score filter (``:210-247``).
:meth:`DetectFrame` is the single-frame entry point of the native net: letterbox ->
:func:`imagenet_preprocess` -> net (anchors decoded inside) -> class
max/argmax -> ``select_and_nms`` (on the GPU: the IoU and scan kernels)
-> letterbox inverse -> ``RectInfo`` rows.  The multi-stream pipeline
drives ``net`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.types import ObjectModelType, RectInfo

from ..engine.torch_engine import to_numpy
from ..models.efficientdet import EfficientDet, EfficientDetSpec
from ..ops.preprocess import LetterboxGeometry, imagenet_preprocess, letterbox
from ..ops.yolo_decode import detections_to_original, select_and_nms
from .object_detector import (ObjectDetectBase, build_net, calibrate, check_engine, open_engine,
                              resolve_device)

#: the options of :class:`EfficientdetDetector` and their defaults
#: (``efficientdet_detector.py:29-43``); ``input_size`` (a multiple of 128)
#: overrides the paper's square input
EFFDET_OPTIONS = {
    "model_path": None,
    "model_type": ObjectModelType.EfficientDet,
    "classes_path": None,
    "box_score": 0.6,
    "box_nms_iou": 0.5,
    "compound": 0,
    "max_det": 100,
    "input_size": None,
    "compute_dtype": None,
}


#: the ImageNet statistics in BGR order, for the BGR-trained zylo117 export
#: (``efficientdet_detector.py:222-226``)
BGR_MEAN = (0.406, 0.456, 0.485)
BGR_STD = (0.225, 0.224, 0.229)


def scores_and_ids(probs: torch.Tensor):
    """(B, N, C) class probabilities -> per-anchor (max score, first class
    attaining it), as ``jnp.max`` / ``jnp.argmax``."""
    return probs.amax(dim=-1), probs.argmax(dim=-1)


class EfficientdetDetector(ObjectDetectBase):
    """EfficientDet-D{0..7} on the port; options as :data:`EFFDET_OPTIONS`
    (``compound`` picks the scale), on ``device`` from the seeded init
    (``seed``) unless ``model_path`` names weights."""

    _defaults = EFFDET_OPTIONS

    def __init__(self, logger=None, engine=None, device="cuda", seed: int = 0, **kwargs):
        super().__init__(EFFDET_OPTIONS, kwargs, logger)
        if self.model_type is not ObjectModelType.EfficientDet:
            raise ValueError(f"EfficientdetDetector can't use {self.model_type} type.")
        if self.compute_dtype not in (None, "int8"):
            raise ValueError(f"EfficientDet compute_dtype is None or 'int8', got "
                             f"{self.compute_dtype!r}")
        self.device = resolve_device(device)
        self._initialize_class(self.classes_path)
        check_engine(engine)
        if engine is None and str(self.model_path).endswith(".onnx"):
            engine = open_engine(self.model_path, self.device, onnx_graph=True)
        self.engine = engine
        if engine is not None:
            self.set_input_details(engine)
            self.set_output_details(engine)
            return
        num_classes, importers = len(self.class_names), {}
        if str(self.model_path).endswith((".pth", ".pt")):
            from ..tools.efficientdet_import import efficientdet_variables
            from ..tools.torch_import import load_state_dict

            state = load_state_dict(self.model_path)
            # the graph takes the checkpoint's class count (9 anchors a cell)
            num_classes = state["classifier.header.pointwise_conv.conv.bias"].size // 9
            importers[(".pth", ".pt")] = lambda _: efficientdet_variables(state, self.spec)
        self.spec = EfficientDetSpec(
            compound=int(self.compound), num_classes=num_classes,
            input_size_override=self.input_size,
        )
        int8 = self.compute_dtype == "int8"
        self.net = build_net(
            lambda: EfficientDet(self.spec, int8=int8), self.device, self.compute_dtype,
            self.model_path, seed, importers=importers,
        )

    def calibrate_int8(self, frames) -> None:
        """Static activation scales from sample BGR frames
        (``efficientdet_detector.py:138``): each frame letterboxed and
        normalized by :func:`imagenet_preprocess`, as the JAX facade does."""
        if self.compute_dtype != "int8":
            raise ValueError("calibrate_int8 requires compute_dtype='int8'")
        if self.engine is not None:
            raise ValueError("calibration needs the native-graph path")
        s = self.spec.input_size
        calibrate(self.net, (
            imagenet_preprocess(f, LetterboxGeometry(f.shape[0], f.shape[1], s, s),
                                device=self.device)
            for f in frames
        ))

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
        if self.engine is not None:
            self._detect_via_engine(srcimg)
            return
        self._object_info = self._dets_to_rectinfo(self.detect(srcimg)[0].cpu().numpy())

    @torch.inference_mode()
    def _detect_via_engine(self, srcimg: np.ndarray) -> None:
        """The postprocessed export (``efficientdet_detector.py:210-247``):
        letterbox, ImageNet-normalize in BGR order (zylo117's models are
        BGR-trained), run the graph, map its already-selected boxes back to
        the source (on the host, in f64) and keep those at or above
        ``box_score``."""
        h, w = self.input_shapes[-2:]
        geom = LetterboxGeometry(srcimg.shape[0], srcimg.shape[1], h, w)
        img = letterbox(torch.from_numpy(np.ascontiguousarray(srcimg))[None].to(self.device),
                        geom)
        mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=self.device) * 255.0
        std = torch.tensor(BGR_STD, dtype=torch.float32, device=self.device) * 255.0
        x = ((img - mean) / std).permute(0, 3, 1, 2)
        boxes, ids, confs = (to_numpy(o) for o in self.engine.device_inference(x)[:3])
        boxes = boxes.reshape(-1, 4).astype(np.float64)
        ratioh, ratiow = geom.scale_ratio
        padh, padw = geom.pad
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - padw) * ratiow
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - padh) * ratioh
        results = []
        for (x1, y1, x2, y2), cid, conf in zip(boxes, ids.reshape(-1).astype(int),
                                               confs.reshape(-1)):
            if conf < float(self.box_score):
                continue
            label = self.class_names[cid] if 0 <= cid < len(self.class_names) else "unknown"
            results.append(RectInfo(x1, y1, x2 - x1, y2 - y1, conf=float(conf), label=label))
        self._object_info = results
