"""YOLO detector facade (port of ``YoloDetector``,
``adas_tpu/perception/object_detector.py:162``, for every family the JAX
facade builds natively: YOLOv5, v5-lite, v6, v7, v8, v9 and v10, at every
scale and with JAX's scale fallbacks).

Builds the torch net on the card (``device="cuda"``, the default; the
CPU only when the caller names it): weights come, by JAX's suffix
dispatch (``object_detector.py:303-335``), from an ``_int8.npz`` store
(``tools/quantize.load_int8``), a ``params_io`` ``.npz`` (the JAX
package's portable checkpoint), a torch ``.pth``/``.pt`` checkpoint or
the initializers of an ``.onnx`` export (``tools/yolo_import``), or,
with no ``model_path``, from the port's seeded flax-style init.  Where
JAX hands the model to an executor, so does the port: a ``.adas`` file
serves through ``engine/artifact.CompiledEngine``, an ``.onnx`` graph
through ``engine/onnx_engine.OnnxGraphEngine`` (``onnx_mode="graph"``, or
``"auto"`` with initializers that do not map), and ``engine=`` injects
any ``EngineBase`` (``object_detector.py:194-247``).  ``compute_dtype``
is None (f32), ``"bf16"`` (every floating leaf cast, as
``adas_tpu/tools/quantize.py:32-44`` does) or ``"int8"``: the int8 net,
f32 params, its int8 kernels packed at load (``_pack_int8``,
``object_detector.py:291``) and static activation scales from
:meth:`YoloDetector.calibrate_int8` (``object_detector.py:338``).  A
YOLOv6 is served in RepVGG's deploy form, fused at load before the cast
and the packing (``object_detector.py:266-273``).
Options come as keywords over the class's ``_defaults``
(``set_defaults``/``check_defaults``/``get_defaults``, as the JAX
facades): JAX's, the default family YOLOv5 included.

:meth:`YoloDetector.DetectFrame` is the single-frame entry point: one
step per source frame shape (letterbox -> net -> decode -> NMS, on the
GPU the IoU and walk kernels -> letterbox inverse; with ``nms_free`` a
YOLOv10's one-to-one head and its top-k instead of decode and NMS) and one
fetch of the (max_det, 6) rows; a fused ``.adas`` engine is one upload, one
program and one fetch; any other engine runs the preprocess, the engine,
then the decode and ``select_and_nms`` on the device
(``object_detector.py:455-493``).  :meth:`YoloDetector.export_fused`
writes the fused step of one or several source shapes as a ``.adas``
file.  The fused steps call :meth:`YoloDetector.detections` on their preprocessed batch and turn the
rows into ``RectInfo`` through :meth:`YoloDetector._dets_to_rectinfo`.
"""
from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.types import ObjectModelType, RectInfo, hex_to_rgb

from ..render import draw as D
from ..render.text import FONT_HERSHEY_TRIPLEX, get_text_size, put_text

from ..models.quant import calibrating, pack_int8_weights
from ..models.yolo import YoloSpec, build_yolo, resolve_spec
from ..models.yolov6 import fuse_repvgg
from ..ops.preprocess import LetterboxGeometry, frame_to_device, yolo_preprocess
from ..ops.yolo_decode import decode_predictions, detections_to_original, select_and_nms
from ..tools.params_io import flatten_variables
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


def read_weights(model_path, importers: Dict[tuple, Callable[[str], dict]]) -> Dict[str, np.ndarray]:
    """The flat flax dict of ``model_path`` by JAX's suffix dispatch: an
    ``_int8.npz`` store dequantized (``tools/quantize.load_int8``), a
    ``params_io`` ``.npz``, else the facade's ``importers`` ({suffixes:
    path -> flax tree}: a ``.pth``/``.pt`` checkpoint, an ``.onnx``
    export's initializers)."""
    from ..tools.quantize import load_int8

    path = str(model_path)
    if path.endswith("_int8.npz"):
        return flatten_variables(load_int8(path))
    if path.endswith(".npz"):
        return load_npz(path)
    for suffixes, importer in importers.items():
        if path.endswith(suffixes):
            return flatten_variables(importer(path))
    raise ValueError(f"Unsupported weights: {model_path} (expect .npz/.pth/.onnx or None)")


def check_engine(engine) -> None:
    """An injected ``engine`` must be an ``engine.base.EngineBase``."""
    from ..engine.base import EngineBase

    if engine is not None and not isinstance(engine, EngineBase):
        raise TypeError(f"engine must be an EngineBase, got {type(engine).__name__}")


def open_engine(model_path, device: torch.device, onnx_graph: bool):
    """The engine JAX's suffix dispatch picks before any native build
    (``object_detector.py:203-211``): a ``.adas`` file's
    ``CompiledEngine``, an ``.onnx`` graph's ``OnnxGraphEngine`` where
    ``onnx_graph``; else None."""
    path = str(model_path)
    if path.endswith(".adas"):
        from ..engine.artifact import CompiledEngine

        return CompiledEngine(path, device=device)
    if path.endswith(".onnx") and onnx_graph:
        from ..engine.onnx_engine import OnnxGraphEngine

        return OnnxGraphEngine(path, device=device)
    return None


def build_net_or_graph(make, device: torch.device, compute_dtype: Optional[str], model_path,
                       seed: int, fuse=None, importers=None, onnx_fallback=False, logger=None):
    """(:func:`build_net`, None), or with ``onnx_fallback`` for an ``.onnx``
    whose initializers do not map onto the native graph (None, its
    ``OnnxGraphEngine``), as JAX falls back (``object_detector.py:226-241``)."""
    try:
        return build_net(make, device, compute_dtype, model_path, seed, fuse, importers), None
    except (KeyError, NotImplementedError) as err:
        if not (onnx_fallback and str(model_path).endswith(".onnx")):
            raise
        if logger:
            logger.war(f"native weight ingest failed ({err}); executing the ONNX graph instead")
        return None, open_engine(model_path, device, onnx_graph=True)


def build_net(make, device: torch.device, compute_dtype: Optional[str], model_path, seed: int,
              fuse=None, importers=None):
    """Construct ``make()`` on ``device``, fill it from ``model_path``
    (:func:`read_weights`: a flax tree, possibly calibrated and packed) or
    the seeded init, apply ``fuse`` (YOLOv6's RepVGG deploy form; a tree
    already fused, with ``::fused::`` leaves, is loaded into the fused
    structure), cast to the params' dtype, pack the int8 kernels of an int8
    net, freeze."""
    with device:
        net = make()
    if model_path is None:
        init_params(net, seed)
    else:
        flat = read_weights(model_path, importers or {})
        if fuse is not None and any("::fused::" in k for k in flat):
            fuse(net)
        load_flax_variables(net, flat)
    if fuse is not None:
        fuse(net)
    net = net.to(compute_torch_dtype(compute_dtype)).eval().requires_grad_(False)
    if compute_dtype == "int8":
        pack_int8_weights(net)
    return net


@torch.inference_mode()
def calibrate(net, inputs, forward=None) -> None:
    """Static activation scales for an int8 net (``calibrate_act_scales``,
    ``tools/quantize.py:189``): each input (one frame each, as JAX runs
    them) goes through ``forward`` (default ``net``; a YOLOv10's ``both``,
    so that both heads calibrate) in calibration mode; the recorded
    absmaxes are the union max over all of them."""
    with calibrating(net):
        for x in inputs:
            (forward or net)(x)


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

    def set_input_details(self, engine) -> None:
        """Record an engine's input shape (NCHW), channel count and dtype
        (``object_detector.py:75``)."""
        self.input_shapes = tuple(engine.get_engine_input_shape())
        self.input_types = engine.engine_dtype
        self.channel_count = self.input_shapes[1]
        if self.logger:
            self.logger.info(f"-> Input Shape : {self.input_shapes}")

    def set_output_details(self, engine) -> None:
        """Record an engine's output shapes and names
        (``object_detector.py:86``)."""
        self.output_shapes, self.output_names = engine.get_engine_output_shape()
        if self.logger:
            self.logger.info(f"-> Output Shape : {self.output_shapes} Names : "
                             f"{self.output_names}")

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

    @staticmethod
    def cornerRect(img, bbox, t: int = 5, rt: int = 1, colorR=(255, 0, 255),
                   colorC=(0, 255, 0)):
        """The box outline (``rt`` thick, none at 0) and its eight corner
        ticks, a fifth of the shorter side long (``object_detector.py:121``)."""
        xmin, ymin, xmax, ymax = bbox
        tick = max(1, int(min(ymax - ymin, xmax - xmin) * 0.2))
        if rt != 0:
            D.rectangle(img, (xmin, ymin), (xmax, ymax), colorR, rt)
        # the eight ticks as eight 2-point polylines in one native call
        # (each is cv2.line: a thick segment capped at both ends)
        D.polylines(img, [
            [(cx, cy), (cx + dx, cy + dy)] for (cx, cy), (dx, dy) in (
                ((xmin, ymin), (tick, 0)), ((xmin, ymin), (0, tick)),
                ((xmax, ymin), (-tick, 0)), ((xmax, ymin), (0, tick)),
                ((xmin, ymax), (tick, 0)), ((xmin, ymax), (0, -tick)),
                ((xmax, ymax), (-tick, 0)), ((xmax, ymax), (0, -tick)),
            )
        ], False, colorC, t)
        return img

    def DrawDetectedOnFrame(self, frame_show: np.ndarray) -> None:
        """Each detection's keypoints, label box, corner box and label
        (``object_detector.py:140``): the label box is sized with font 0
        and the label drawn in TRIPLEX, as the JAX facade does."""
        tl = 3
        for info in self.object_info:
            xmin, ymin, xmax, ymax = info.tolist()
            label = info.label
            D.circles(frame_show, info.kpss, 1, (255, 255, 255), -1)
            color = self.colors_dict.get(label, (0, 0, 0))
            t_size = get_text_size(label, 0, tl / 3, 2)[0]
            c2 = (xmin + t_size[0], ymin - t_size[1] - 3)
            D.rectangle(frame_show, (xmin, ymin), c2, color, -1, D.LINE_AA)
            self.cornerRect(frame_show, info.tolist(), colorR=color, colorC=color)
            put_text(frame_show, label, (xmin + 2, ymin - 7), FONT_HERSHEY_TRIPLEX, tl / 4,
                     (255, 255, 255), 2)


#: the options of :class:`YoloDetector` and their defaults
#: (``object_detector.py:167-193``)
YOLO_OPTIONS = {
    "model_path": None,
    "model_type": ObjectModelType.YOLOV5,
    "classes_path": None,
    "box_score": 0.4,
    "box_nms_iou": 0.45,
    "scale": "n",
    "max_det": 100,
    "input_size": (640, 640),
    "compute_dtype": None,
    # v10 only: serve the one-to-one head (top-k, no NMS)
    "nms_free": False,
    # .onnx: "ingest" maps the initializers onto the native graph, "auto"
    # falls back to the ONNX graph engine where they do not map, "graph"
    # always runs the graph
    "onnx_mode": "auto",
}

#: ``object_detector.py:36``: the YOLO family of each model type
_FAMILY_OF = {
    ObjectModelType.YOLOV5: "v5",
    ObjectModelType.YOLOV5_LITE: "v5lite",
    ObjectModelType.YOLOV6: "v6",
    ObjectModelType.YOLOV7: "v7",
    ObjectModelType.YOLOV8: "v8",
    ObjectModelType.YOLOV9: "v9",
    ObjectModelType.YOLOV10: "v10",
}


class YoloDetector(ObjectDetectBase):
    """YOLO detector on the port (``object_detector.py:162``); options as
    :data:`YOLO_OPTIONS`, on ``device`` from the seeded init (``seed``)
    unless ``model_path`` names weights (:func:`read_weights`, with
    ``tools/yolo_import.yolo_variables`` for ``.pth``/``.pt`` and
    ``.onnx``) or an engine's file (:func:`open_engine`); ``engine`` (an
    ``EngineBase``) replaces the native net, the decode staying on the
    device.  ``nms_free`` on a model that is not YOLOv10 raises here (JAX
    raises at the first step)."""

    _defaults = YOLO_OPTIONS

    def __init__(self, logger=None, engine=None, device="cuda", seed: int = 0, **kwargs):
        super().__init__(YOLO_OPTIONS, kwargs, logger)
        family = _FAMILY_OF.get(self.model_type)
        if family is None:
            raise ValueError(f"YoloDetector can't use {self.model_type} type.")
        if self.nms_free and family != "v10":
            raise ValueError("nms_free serving requires a YOLOv10 model")
        self.device = resolve_device(device)
        self._initialize_class(self.classes_path)
        # the scale JAX serves (v9 -> c, v6 and v5-lite -> s when unknown)
        self.spec = resolve_spec(YoloSpec(
            scale=self.scale, num_classes=len(self.class_names),
            input_size=tuple(self.input_size), family=family,
        ))
        check_engine(engine)
        if engine is None:
            engine = open_engine(self.model_path, self.device, self.onnx_mode == "graph")
        if engine is None:
            cd = self.compute_dtype
            self.net, engine = build_net_or_graph(
                lambda: build_yolo(self.spec, int8=cd == "int8"), self.device, cd,
                self.model_path, seed, fuse=fuse_repvgg if family == "v6" else None,
                importers=self._importers(), onnx_fallback=self.onnx_mode == "auto",
                logger=self.logger,
            )
        self.engine = engine
        if engine is not None:
            self.set_input_details(engine)
            self.set_output_details(engine)
            h, w = engine.get_engine_input_shape()[2:]
            self.spec = YoloSpec(scale=self.spec.scale, num_classes=self.spec.num_classes,
                                 input_size=(int(h), int(w)), family=family)
        self._steps = {}
        if self.logger:
            self.logger.info(
                f"YoloDetector [{self.model_type.name}-{self.spec.scale}] input "
                f"{self.spec.input_size} torch {self.device}"
            )

    def _importers(self):
        """The ``.pth``/``.pt`` and ``.onnx`` readers of :func:`read_weights`
        (``object_detector.py:318-331``)."""
        from ..tools.onnx_import import read_onnx_initializers
        from ..tools.torch_import import load_state_dict
        from ..tools.yolo_import import yolo_variables

        return {(".pth", ".pt"): lambda p: yolo_variables(load_state_dict(p), self.spec),
                (".onnx",): lambda p: yolo_variables(read_onnx_initializers(p), self.spec)}

    def calibrate_int8(self, frames) -> None:
        """Static activation scales from sample BGR frames
        (``object_detector.py:338``): each frame letterboxed through
        :func:`yolo_preprocess` in f32, as the JAX facade does."""
        if self.compute_dtype != "int8":
            raise ValueError("calibrate_int8 requires compute_dtype='int8'")
        if self.engine is not None:
            raise ValueError("calibration needs the native-graph path")
        h, w = self.spec.input_size
        calibrate(self.net, (
            yolo_preprocess(f, LetterboxGeometry(f.shape[0], f.shape[1], h, w), device=self.device)
            for f in frames
        ), getattr(self.net, "both", None))

    def detections(self, x: torch.Tensor, nms_free: bool) -> torch.Tensor:
        """The net on a preprocessed batch ``x`` -> (B, max_det, 6)
        detection rows in letterbox coordinates, zero-padded
        (``object_detector.py:389-417``): decode + NMS, or with
        ``nms_free`` the one-to-one head's top-k rows with a score below
        ``box_score`` zeroed."""
        box_score, max_det = float(self.box_score), int(self.max_det)
        if nms_free:
            dets = self.net.one2one(x).float()
            return (dets * (dets[..., 4:5] >= box_score).float())[:, :max_det]
        boxes, scores, ids = decode_predictions(
            self.net(x).float(), self.model_type, self.spec.num_classes, self.spec.input_size,
        )
        return select_and_nms(boxes, scores, ids, box_score=box_score,
                              iou_threshold=float(self.box_nms_iou), max_det=max_det)

    def _build_step(self, src_shape):
        """The step for one source frame shape (``object_detector.py:370``):
        (H, W, 3) uint8 BGR on the device -> (max_det, 6) detection rows in
        source coordinates (:meth:`detections`).  The net's input is bf16
        for a bf16 net only: an int8 net takes f32 here, as the JAX facade
        feeds it (``:383-386``; its stem rounds to bf16 either way)."""
        h, w = self.spec.input_size
        geom = LetterboxGeometry(src_shape[0], src_shape[1], h, w)
        in_dtype = torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32
        nms_free = bool(self.nms_free)

        @torch.inference_mode()
        def step(frame: torch.Tensor) -> torch.Tensor:
            x = yolo_preprocess(frame, geom, dtype=in_dtype, device=self.device)
            return detections_to_original(self.detections(x, nms_free), geom)[0]

        return step

    def export_fused(self, out_path: str, frame_hw, platforms=None) -> dict:
        """Write the fused step (uint8 frame -> (max_det, 6) detections in
        source coordinates) as a ``.adas`` file (``object_detector.py:420``):
        one upload, one program and one fetch a frame.  ``frame_hw`` is one
        (h, w) or a list of them (one program per source shape, picked by
        the frame's shape at run time); ``platforms`` is this facade's
        device type (the default).  Returns the metadata written."""
        from ..engine.artifact import build_fused_artifact_multi
        from ..utils.misc import _norm_frame_hws

        if self.engine is not None:
            raise ValueError("export_fused needs the native-graph path")
        return build_fused_artifact_multi(
            self._build_step, _norm_frame_hws(frame_hw), out_path,
            platforms=[self.device.type] if platforms is None else platforms,
            device=self.device,
            meta={
                "kind": "yolo",
                "model": self.model_type.name,
                "scale": self.spec.scale,
                "net_input_size": list(self.spec.input_size),
            },
        )

    def DetectFrame(self, srcimg: np.ndarray) -> None:
        """Detect on one BGR uint8 frame; the result is :attr:`object_info`
        (``object_detector.py:455``)."""
        if self.engine is not None:
            if getattr(self.engine, "fused", False):
                from ..engine.artifact import check_fused_frame

                dets = self.engine.run_device(check_fused_frame(self.engine, srcimg))
                self._object_info = self._dets_to_rectinfo(dets.cpu().numpy())
            else:
                self._detect_via_engine(srcimg)
            return
        src_shape = srcimg.shape[:2]
        if src_shape not in self._steps:
            self._steps[src_shape] = self._build_step(src_shape)
        dets = self._steps[src_shape](frame_to_device(srcimg, self.device))
        self._object_info = self._dets_to_rectinfo(dets.cpu().numpy())

    @torch.inference_mode()
    def _detect_via_engine(self, srcimg: np.ndarray) -> None:
        """An engine's net (``object_detector.py:474-493``): the letterbox
        on the device, the engine on the NCHW blob, then the decode and
        ``select_and_nms`` on the device (on the GPU the IoU and walk
        kernels) and the letterbox inverse."""
        h, w = self.spec.input_size
        geom = LetterboxGeometry(srcimg.shape[0], srcimg.shape[1], h, w)
        x = yolo_preprocess(srcimg, geom, device=self.device)
        raw = self.engine.device_inference(x)[0].to(self.device, torch.float32)
        if raw.dim() == 2:
            raw = raw[None]
        boxes, scores, ids = decode_predictions(
            raw[:1], self.model_type, self.spec.num_classes, self.spec.input_size)
        dets = select_and_nms(boxes, scores, ids, box_score=float(self.box_score),
                              iou_threshold=float(self.box_nms_iou), max_det=int(self.max_det))
        self._object_info = self._dets_to_rectinfo(
            detections_to_original(dets, geom)[0].cpu().numpy())
