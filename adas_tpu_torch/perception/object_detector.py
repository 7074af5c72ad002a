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
:meth:`YoloDetector.calibrate_int8` (``object_detector.py:338``).  The
multi-stream pipeline drives ``net`` directly and turns its detections
into ``RectInfo`` rows through :meth:`YoloDetector._dets_to_rectinfo`.
"""
from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.types import ObjectModelType, RectInfo, hex_to_rgb

from ..models.quant import calibrating, pack_int8_weights
from ..models.yolo import YoloSpec, YoloV8
from ..ops.preprocess import LetterboxGeometry, yolo_preprocess
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
    """Class names, colours and the detection rows -> ``RectInfo`` step
    shared by the object detectors (``object_detector.py:47``)."""

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


class YoloDetector(ObjectDetectBase):
    """YOLOv8 detector on the port (``object_detector.py:162``)."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_type: ObjectModelType = ObjectModelType.YOLOV8,
        scale: str = "n",
        box_score: float = 0.4,
        box_nms_iou: float = 0.45,
        max_det: int = 100,
        input_size: Tuple[int, int] = (640, 640),
        compute_dtype: Optional[str] = None,
        classes_path: Optional[str] = None,
        device="cuda",
        seed: int = 0,
    ):
        if model_type is not ObjectModelType.YOLOV8:
            raise ValueError(f"the port serves YOLOV8 only, got {model_type}")
        self.model_type = model_type
        self.box_score = box_score
        self.box_nms_iou = box_nms_iou
        self.max_det = max_det
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self._initialize_class(classes_path)
        self.spec = YoloSpec(
            scale=scale, num_classes=len(self.class_names), input_size=tuple(input_size)
        )
        self.net = build_net(
            lambda: YoloV8(self.spec, int8=compute_dtype == "int8"), self.device,
            compute_dtype, model_path, seed,
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
