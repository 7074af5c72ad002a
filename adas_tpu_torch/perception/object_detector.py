"""YOLO detector facade (port of the YOLOv8 part of ``YoloDetector``,
``adas_tpu/perception/object_detector.py:162``).

Builds the torch net on the card (``device="cuda"``, the default; the
CPU only when the caller names it): weights come from a
``params_io`` ``.npz`` (the JAX package's portable checkpoint) or, with no
``model_path``, from the port's seeded flax-style init.  ``compute_dtype``
is None (f32), ``"bf16"`` (every floating leaf cast, as
``adas_tpu/tools/quantize.py:32-44`` does) or ``"int8"``: the int8 net,
f32 params, its int8 kernels packed at load (``_pack_int8``,
``object_detector.py:291``) and static activation scales from
:meth:`YoloDetector.calibrate_int8` (``object_detector.py:338``).
Options come as keywords over the class's ``_defaults``
(``set_defaults``/``check_defaults``/``get_defaults``, as the JAX
facades); the ONNX, ``.adas`` engine and YOLOv10 options are not ported.

:meth:`YoloDetector.DetectFrame` is the single-frame entry point: one
step per source frame shape (letterbox -> net -> decode -> NMS, on the
GPU the IoU and walk kernels -> letterbox inverse) and one fetch of the
(max_det, 6) rows.  The multi-stream pipeline drives ``net`` directly
and turns its detections into ``RectInfo`` rows through
:meth:`YoloDetector._dets_to_rectinfo`.
"""
from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np
import torch

from ..utils.types import ObjectModelType, RectInfo, hex_to_rgb

from ..models.quant import calibrating, pack_int8_weights
from ..models.yolo import YoloSpec, YoloV8
from ..ops.preprocess import LetterboxGeometry, frame_to_device, yolo_preprocess
from ..ops.yolo_decode import decode_predictions, detections_to_original, select_and_nms
from ..weights import init_params, load_flax_variables, load_npz

DEFAULT_CLASSES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "coco_label.txt"
)

#: the params' dtype per compute dtype (an int8 net keeps f32 params)
_COMPUTE_DTYPES = {None: torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU raises
    (there is no CPU fallback for a requested GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, got {device!r}")
    return dev


def compute_torch_dtype(compute_dtype: Optional[str]) -> torch.dtype:
    """The params' dtype for ``compute_dtype`` (None, "bf16" or "int8")."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be None (f32), 'bf16' or 'int8', got {compute_dtype!r}")
    return _COMPUTE_DTYPES[compute_dtype]


def input_torch_dtype(compute_dtype: Optional[str]) -> torch.dtype:
    """The net input's dtype on the serving path: bf16 under int8 too (the
    stem is bf16 by the precision policy, ``multistream.py:190-205``)."""
    return torch.float32 if compute_dtype is None else torch.bfloat16


def build_net(make, device: torch.device, compute_dtype: Optional[str], model_path, seed: int):
    """Construct ``make()`` on ``device``, fill it from ``model_path``
    (flax ``.npz``, possibly calibrated and packed) or the seeded init,
    cast to the params' dtype, pack the int8 kernels of an int8 net,
    freeze."""
    with device:
        net = make()
    if model_path is None:
        init_params(net, seed)
    elif str(model_path).endswith(".npz"):
        load_flax_variables(net, load_npz(model_path))
    else:
        raise ValueError(f"unsupported weights {model_path} (expect a params_io .npz or None)")
    net = net.to(compute_torch_dtype(compute_dtype)).eval().requires_grad_(False)
    if compute_dtype == "int8":
        pack_int8_weights(net)
    return net


@torch.inference_mode()
def calibrate(net, inputs) -> None:
    """Static activation scales for an int8 net (``calibrate_act_scales``,
    ``tools/quantize.py:189``): each input (one frame each, as JAX runs
    them) goes through the net in calibration mode; the recorded absmaxes
    are the union max over all of them."""
    with calibrating(net):
        for x in inputs:
            net(x)


class ObjectDetectBase:
    """Options, class names, colours and the detection rows -> ``RectInfo``
    step shared by the object detectors (``object_detector.py:47``)."""

    _defaults = {
        "model_path": None,
        "model_type": None,
        "classes_path": None,
        "box_score": None,
    }

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

    def __init__(self, options: dict, kwargs: dict, logger=None):
        """Set every option from ``kwargs`` over the class's current
        ``_defaults`` over ``options`` (the facade's own defaults, whose
        keys are the options it takes: any other raises)."""
        config = {**options, **self._defaults, **kwargs}
        unknown = sorted(set(config) - set(options))
        if unknown:
            raise TypeError(f"{type(self).__name__} does not take {unknown}")
        self.__dict__.update(config)
        self.logger = logger

    def _initialize_class(self, classes_path: Optional[str]) -> None:
        classes_path = os.path.expanduser(classes_path or DEFAULT_CLASSES)
        if not os.path.isfile(classes_path):
            raise FileNotFoundError(f"{classes_path} is not exist.")
        with open(classes_path) as f:
            self.class_names = [c.strip() for c in f.readlines()]
        colors = [hex_to_rgb("#%06x" % random.randint(0, 0xFFFFFF)) for _ in self.class_names]
        self.colors_dict = dict(zip(self.class_names, colors))

    def _dets_to_rectinfo(self, dets: np.ndarray) -> List[RectInfo]:
        """(max_det, 6) rows -> RectInfo list, skipping zero-score padding
        (``object_detector.py:495``)."""
        results = []
        for x1, y1, x2, y2, score, cid in dets:
            if score <= 0:
                continue
            cid = int(cid)
            label = self.class_names[cid] if 0 <= cid < len(self.class_names) else "unknown"
            results.append(RectInfo(x1, y1, x2 - x1, y2 - y1, conf=float(score), label=label))
        return results

    @property
    def object_info(self) -> List[RectInfo]:
        """The detections of the last :meth:`DetectFrame` call."""
        return getattr(self, "_object_info", [])


#: the options of :class:`YoloDetector` and their defaults
#: (``object_detector.py:167-189``, less the engine, ONNX and v10 ones)
YOLO_OPTIONS = {
    "model_path": None,
    "model_type": ObjectModelType.YOLOV8,
    "classes_path": None,
    "box_score": 0.4,
    "box_nms_iou": 0.45,
    "scale": "n",
    "max_det": 100,
    "input_size": (640, 640),
    "compute_dtype": None,
}


class YoloDetector(ObjectDetectBase):
    """YOLOv8 detector on the port (``object_detector.py:162``); options as
    :data:`YOLO_OPTIONS`, on ``device`` from the seeded init (``seed``)
    unless ``model_path`` names weights."""

    _defaults = YOLO_OPTIONS

    def __init__(self, logger=None, device="cuda", seed: int = 0, **kwargs):
        super().__init__(YOLO_OPTIONS, kwargs, logger)
        if self.model_type is not ObjectModelType.YOLOV8:
            raise ValueError(f"the port serves YOLOV8 only, got {self.model_type}")
        self.device = resolve_device(device)
        self._initialize_class(self.classes_path)
        self.spec = YoloSpec(
            scale=self.scale, num_classes=len(self.class_names),
            input_size=tuple(self.input_size),
        )
        cd = self.compute_dtype
        self.net = build_net(
            lambda: YoloV8(self.spec, int8=cd == "int8"), self.device, cd, self.model_path, seed,
        )
        self._steps = {}
        if self.logger:
            self.logger.info(
                f"YoloDetector [{self.model_type.name}-{self.spec.scale}] input "
                f"{self.spec.input_size} torch {self.device}"
            )

    def calibrate_int8(self, frames) -> None:
        """Static activation scales from sample BGR frames
        (``object_detector.py:338``): each frame letterboxed through
        :func:`yolo_preprocess` in f32, as the JAX facade does."""
        if self.compute_dtype != "int8":
            raise ValueError("calibrate_int8 requires compute_dtype='int8'")
        h, w = self.spec.input_size
        calibrate(self.net, (
            yolo_preprocess(f, LetterboxGeometry(f.shape[0], f.shape[1], h, w), device=self.device)
            for f in frames
        ))

    def _build_step(self, src_shape):
        """The step for one source frame shape (``object_detector.py:370``):
        (H, W, 3) uint8 BGR on the device -> (max_det, 6) detection rows in
        source coordinates.  The net's input is bf16 for a bf16 net only:
        an int8 net takes f32 here, as the JAX facade feeds it
        (``:383-386``; its stem rounds to bf16 either way)."""
        h, w = self.spec.input_size
        geom = LetterboxGeometry(src_shape[0], src_shape[1], h, w)
        in_dtype = torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32
        box_score, iou, max_det = float(self.box_score), float(self.box_nms_iou), int(self.max_det)

        @torch.inference_mode()
        def step(frame: torch.Tensor) -> torch.Tensor:
            x = yolo_preprocess(frame, geom, dtype=in_dtype, device=self.device)
            boxes, scores, ids = decode_predictions(self.net(x).float())
            dets = select_and_nms(
                boxes, scores, ids, box_score=box_score, iou_threshold=iou, max_det=max_det,
            )
            return detections_to_original(dets, geom)[0]

        return step

    def DetectFrame(self, srcimg: np.ndarray) -> None:
        """Detect on one BGR uint8 frame; the result is :attr:`object_info`
        (``object_detector.py:455``)."""
        src_shape = srcimg.shape[:2]
        if src_shape not in self._steps:
            self._steps[src_shape] = self._build_step(src_shape)
        dets = self._steps[src_shape](frame_to_device(srcimg, self.device))
        self._object_info = self._dets_to_rectinfo(dets.cpu().numpy())
