"""UFLD lane detector facades (port of ``UltrafastLaneDetectorV2``,
``adas_tpu/perception/lane_detector.py:100``, on CULane, TuSimple and
CurveLanes, and ``UltrafastLaneDetector``, UFLD v1, ``:343``, on TuSimple
and CULane).

Same weight and dtype handling as ``object_detector.YoloDetector``
(``compute_dtype="int8"`` is the JAX facade's ``dtype="int8"``,
``lane_detector.py:146-160``).  :meth:`UltrafastLaneDetectorV2.DetectFrame`
is the single-frame entry point: preprocess -> net -> ``ufld_v2_decode``
-> ``pack`` on the device, one fetch, then the point assembly on the
host.  The multi-stream pipeline drives ``net`` directly and assembles
each stream's lane points with :meth:`_assemble` / :meth:`_finalize`.
The drawing (``DrawDetectedOnFrame``, ``DrawAreaOnFrame``,
``AutoDrawLanes``) uses the port's cv2-free renderer.  UFLD v1 serves f32
and bf16 (:class:`UltrafastLaneDetector`: preprocess -> net ->
``ufld_v1_decode`` on the device, one fetch of the grid locations, the
reference's point math on the host) and int8, which JAX serves
uncalibrated (dynamic scales, ``lane_detector.py:379-388``).  As in JAX,
a ``.adas`` model_path serves through ``engine/artifact.CompiledEngine``
(a fused one: one upload, one program, one fetch), an ``.onnx`` whose
initializers do not map through ``engine/onnx_engine.OnnxGraphEngine``,
and ``engine=`` injects any ``EngineBase`` (preprocess, engine, then the
decode on the device); ``export_fused`` writes the fused step as a
``.adas`` file (``lane_detector.py:237-300``, ``:428-460``).  The JAX
``UltrafastLaneDetectorV2`` refuses ``UFLDV2_CURVELANES``
(``lane_detector.py:125-128``); the port builds it from its spec row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.types import LANE_COLORS, LaneInfo, LaneModelType, OffsetType

from ..render import draw as D

from ..models.ufld import UFLDV1_SPECS, UFLDV2_SPECS, UFLDv1Net, UFLDv2Net
from ..ops.packing import pack, unpack
from ..ops.preprocess import frame_to_device, ufld_v1_preprocess, ufld_v2_preprocess
from ..ops.ufld_decode import ufld_v1_decode, ufld_v2_decode
from .object_detector import (build_net_or_graph, calibrate, check_engine, open_engine,
                              resolve_device)


class LaneDetectBase:
    """Options and lane state shared by the lane detectors
    (``lane_detector.py:33``)."""

    _defaults = {"model_path": None, "model_type": None}

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

    def __init__(self, logger=None):
        self.__dict__.update(self._defaults)
        self.logger = logger
        self.adjust_lanes = False
        self.lane_info = LaneInfo()

    def DrawDetectedOnFrame(self, image, type: OffsetType = OffsetType.UNKNOWN,
                            alpha: float = 0.3) -> None:
        """Each lane's points as radius-3 discs, the departing ego lane in
        red, blended ``alpha`` over the frame (``lane_detector.py:59``)."""
        overlay = image.copy()
        for lane_num, lane_points in enumerate(self.lane_info.lanes_points):
            if lane_num == 1 and type == OffsetType.RIGHT:
                color = (0, 0, 255)
            elif lane_num == 2 and type == OffsetType.LEFT:
                color = (0, 0, 255)
            else:
                color = LANE_COLORS[lane_num]
            D.circles(overlay, [(int(x), int(y)) for x, y in lane_points], 3, color, -1)
        image[:] = D.add_weighted(overlay, alpha, image, 1 - alpha, 0)

    def DrawAreaOnFrame(self, image, color: tuple = (255, 191, 0), alpha: float = 0.85) -> None:
        """The ego-lane area filled in ``color`` under the frame at
        ``1 - alpha`` (``lane_detector.py:76``)."""
        if self.lane_info.area_status and len(self.lane_info.area_points):
            overlay = image.copy()
            D.fill_poly(overlay, [np.asarray(self.lane_info.area_points, np.int32)], color)
            image[:] = D.add_weighted(image, alpha, overlay, 1 - alpha, 0)

    def AutoDrawLanes(self, image, draw_points: bool = True, draw_area: bool = True):
        """Detect with ``adjust_lanes`` and draw (``lane_detector.py:87``)."""
        self.DetectFrame(image, adjust_lanes=True)
        if draw_points:
            self.DrawDetectedOnFrame(image)
        if draw_area:
            self.DrawAreaOnFrame(image)
        return image

    def _init_net(self, model_path, model_type, specs, compute_dtype, device, seed, make,
                  engine=None, backbone=None, version=2, n_outputs=4) -> None:
        """The facades' construction: ``model_path`` and ``model_type`` over
        the class's ``_defaults``, the type checked against ``specs``, the
        type's spec on a ``backbone`` trunk where one is given, then the
        engine (``engine``, a ``.adas`` file, or an ``.onnx`` whose
        initializers do not map; a net's engine must give ``n_outputs``
        tensors) or ``make(spec)`` built on ``device``
        (``object_detector.build_net``) with UFLD ``version``'s importers."""
        if model_path is not None:
            self.model_path = model_path
        if model_type is not None:
            self.model_type = model_type
        if self.model_type not in specs:
            msg = f"{type(self).__name__} can't use {self.model_type} type."
            if self.logger:
                self.logger.error(msg)
            raise ValueError(msg)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.spec = specs[self.model_type]
        if backbone is not None:
            self.spec = dataclasses.replace(self.spec, backbone=str(backbone))
        check_engine(engine)
        if engine is None:
            engine = open_engine(self.model_path, self.device, onnx_graph=False)
        if engine is None:
            # JAX executes an .onnx graph whose names do not map (lane_detector.py:162-173)
            self.net, engine = build_net_or_graph(
                lambda: make(self.spec), self.device, compute_dtype, self.model_path, seed,
                importers=self._importers(version), onnx_fallback=True, logger=self.logger)
        self.engine = engine
        if engine is not None and not getattr(engine, "fused", False):
            outs, _ = engine.get_engine_output_shape()
            if len(outs) != n_outputs:
                raise ValueError(
                    "UFLDv2 engine must emit 4 tensors (loc_row/loc_col/exist_row/exist_col), "
                    f"got {len(outs)}" if version == 2 else
                    f"UFLD v1 engine must emit 1 tensor, got {len(outs)}")

    def _importers(self, version: int):
        """``.pth``/``.pt`` and ``.onnx`` through ``ufld_variables``
        (``lane_detector.py:513-533``)."""
        from ..tools.onnx_import import read_onnx_initializers
        from ..tools.torch_import import load_state_dict, ufld_variables

        fc_norm = getattr(self.spec, "fc_norm", True)
        return {
            (".pth", ".pt"): lambda p: ufld_variables(load_state_dict(p), version, fc_norm),
            (".onnx",): lambda p: ufld_variables(read_onnx_initializers(p), version, fc_norm),
        }

    def _finalize(self, img_height: int) -> None:
        """``lane_detector.py:95``."""
        self.lane_info.update_status()
        self.lane_info.update_area(img_height, adjust_lanes=self.adjust_lanes)


class UltrafastLaneDetectorV2(LaneDetectBase):
    """UFLDv2 lane detector on the port (``lane_detector.py:100``): the
    class's ``_defaults`` give ``model_path`` and ``model_type`` where the
    caller passes None; ``compute_dtype`` None (f32), ``"bf16"`` or
    ``"int8"``; ``backbone`` the trunk's depth (``"18"``, ``"34"`` or
    ``"50"``, a ``configs/ufldv2`` file's ``backbone``; None: the type's
    ResNet-18), on the type's geometry."""

    _defaults = {"model_path": None, "model_type": LaneModelType.UFLDV2_CULANE}

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_type: Optional[LaneModelType] = None,
        logger=None,
        compute_dtype: Optional[str] = None,
        engine=None,
        device="cuda",
        seed: int = 0,
        backbone: Optional[str] = None,
    ):
        super().__init__(logger)
        self._init_net(model_path, model_type, UFLDV2_SPECS, compute_dtype, device, seed,
                       lambda spec: UFLDv2Net(spec, int8=compute_dtype == "int8"), engine,
                       backbone)
        if self.logger:
            self.logger.info(
                f"UfldDetectorV2 [{self.model_type.name}] input "
                f"{self.spec.input_height}x{self.spec.input_width} torch {self.device}"
            )

    def calibrate_int8(self, frames) -> None:
        """Static activation scales from sample BGR frames
        (``lane_detector.py:189``), preprocessed by
        :func:`ufld_v2_preprocess` in f32 (the JAX int8 net's dtype)."""
        if self.compute_dtype != "int8":
            raise ValueError("calibrate_int8 requires compute_dtype='int8'")
        if self.engine is not None:
            raise ValueError("calibration needs the native-graph path")
        s = self.spec
        calibrate(self.net, (
            ufld_v2_preprocess(f, s.input_height, s.input_width, s.crop_ratio, device=self.device)
            for f in frames
        ))

    @torch.inference_mode()
    def _step(self, frame: torch.Tensor):
        """(H, W, 3) uint8 BGR on the device -> the decoded lane tensors
        packed into one (1, total) f32 tensor, and the pack spec
        (``lane_detector.py:211``).  The net's input is bf16 for a bf16
        net, else f32 (an int8 net's, as the JAX facade feeds it)."""
        s = self.spec
        in_dtype = torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32
        x = ufld_v2_preprocess(
            frame, s.input_height, s.input_width, s.crop_ratio, dtype=in_dtype, device=self.device,
        )
        outputs = {k: v.float() for k, v in self.net(x).items()}
        return pack(ufld_v2_decode(outputs))

    def export_fused(self, out_path: str, frame_hw, platforms=None) -> dict:
        """Write the fused step (uint8 frame -> the decoded lanes packed in
        one vector) as a ``.adas`` file (``lane_detector.py:237``), with
        the pack layout in its metadata; ``frame_hw`` one (h, w) or a list
        of them.  Returns the metadata written."""
        from ..engine.artifact import build_fused_artifact_multi, pack_spec_meta
        from ..utils.misc import _norm_frame_hws

        if self.engine is not None:
            raise ValueError("export_fused needs the native-graph path")
        hws = _norm_frame_hws(frame_hw)
        frame = torch.zeros((*hws[0], 3), dtype=torch.uint8, device=self.device)
        structure, shapes = self._step(frame)[1]
        # JAX packs the batch-1 decode: each leaf (1, R, L) or (1, C, L)
        spec = (structure, [((1, *shape), dtype) for shape, dtype in shapes])
        return build_fused_artifact_multi(
            lambda hw: lambda x: self._step(x)[0][0], hws, out_path,
            platforms=[self.device.type] if platforms is None else platforms,
            device=self.device,
            meta={"kind": "ufldv2", "model": self.model_type.name, **pack_spec_meta(spec)},
        )

    def DetectFrame(self, image: np.ndarray, adjust_lanes: bool = False) -> None:
        """Detect lanes on one BGR uint8 frame; the result is
        :attr:`lane_info` (``lane_detector.py:269``)."""
        h, w = image.shape[:2]
        if self.engine is not None and getattr(self.engine, "fused", False):
            from ..engine.artifact import check_fused_frame, unpack_from_meta

            flat = self.engine.run_device(check_fused_frame(self.engine, image))
            decoded = {k: v[0] for k, v in unpack_from_meta(
                flat.cpu().numpy(), self.engine.meta["pack"]).items()}
        elif self.engine is not None:
            decoded = self._detect_via_engine(image)
        else:
            flat, spec = self._step(frame_to_device(image, self.device))
            decoded = unpack(flat.cpu().numpy()[0], spec)
        self.adjust_lanes = adjust_lanes
        self._assemble(decoded, w, h)
        self._finalize(h)

    @torch.inference_mode()
    def _detect_via_engine(self, image: np.ndarray) -> dict:
        """An engine's net (``lane_detector.py:287``): the preprocess on the
        device, the engine on the NCHW blob, the decode on the device."""
        s = self.spec
        x = ufld_v2_preprocess(image, s.input_height, s.input_width, s.crop_ratio,
                               device=self.device)
        outs = self.engine.device_inference(x)
        names = ("loc_row", "loc_col", "exist_row", "exist_col")
        decoded = ufld_v2_decode({k: v.to(self.device, torch.float32)
                                  for k, v in zip(names, outs)})
        return {k: v[0].cpu().numpy() for k, v in decoded.items()}

    def _assemble(self, decoded: dict, img_w: int, img_h: int) -> None:
        """Host-side point-list assembly for one frame (``decoded`` leaves
        are (R, L) / (C, L) numpy arrays; ``lane_detector.py:304``)."""
        s = self.spec
        row_x = decoded["row_x"] * img_w
        row_valid = decoded["row_valid"]
        col_y = decoded["col_y"] * img_h
        col_valid = decoded["col_valid"]
        row_anchor, col_anchor = s.row_anchor, s.col_anchor

        points = {k: [] for k in ("left-side", "left-ego", "right-ego", "right-side")}
        detected = {k: False for k in points}
        for i, key in ((1, "left-ego"), (2, "right-ego")):
            if row_valid[:, i].sum() > s.num_row / 2:
                pts = [
                    (int(row_x[k, i]), int(row_anchor[k] * img_h))
                    for k in range(s.num_row)
                    if row_valid[k, i]
                ]
                points[key].extend(pts)
                if len(pts) > 2:
                    detected[key] = True
        for i, key in ((0, "left-side"), (3, "right-side")):
            if col_valid[:, i].sum() > s.num_col / 4:
                pts = [
                    (int(col_anchor[k] * img_w), int(col_y[k, i]))
                    for k in range(s.num_col)
                    if col_valid[k, i]
                ]
                points[key].extend(pts)
                if len(pts) > 2:
                    detected[key] = True

        self.lane_info.lanes_points = np.array(list(points.values()), dtype=object)
        self.lane_info.lanes_status = list(detected.values())


class UltrafastLaneDetector(LaneDetectBase):
    """UFLD v1 lane detector on the port (``lane_detector.py:343``): the
    class's ``_defaults`` give ``model_path`` and ``model_type`` where the
    caller passes None; ``compute_dtype`` None (f32), ``"bf16"`` or
    ``"int8"`` (the JAX facade's ``dtype="int8"``: packed weights, dynamic
    input scales, f32 input)."""

    _defaults = {"model_path": None, "model_type": LaneModelType.UFLD_TUSIMPLE}

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_type: Optional[LaneModelType] = None,
        logger=None,
        compute_dtype: Optional[str] = None,
        engine=None,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__(logger)
        self._init_net(model_path, model_type, UFLDV1_SPECS, compute_dtype, device, seed,
                       lambda spec: UFLDv1Net(spec, int8=compute_dtype == "int8"), engine,
                       version=1, n_outputs=1)
        if self.logger:
            self.logger.info(
                f"UfldDetector [{self.model_type.name}] input "
                f"{self.spec.input_height}x{self.spec.input_width} torch {self.device}"
            )

    @torch.inference_mode()
    def _step(self, frame: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 BGR on the device -> (1, rows, lanes) grid
        locations (``lane_detector.py:420``)."""
        s = self.spec
        in_dtype = torch.bfloat16 if self.compute_dtype == "bf16" else torch.float32
        x = ufld_v1_preprocess(frame, s.input_height, s.input_width, dtype=in_dtype,
                               device=self.device)
        return ufld_v1_decode(self.net(x).float())

    def export_fused(self, out_path: str, frame_hw, platforms=None) -> dict:
        """Write the fused v1 step (uint8 frame -> the decoded (1, rows,
        lanes) grid) as a ``.adas`` file (``lane_detector.py:428``)."""
        from ..engine.artifact import build_fused_artifact_multi
        from ..utils.misc import _norm_frame_hws

        if self.engine is not None:
            raise ValueError("export_fused needs the native-graph path")
        return build_fused_artifact_multi(
            lambda hw: self._step, _norm_frame_hws(frame_hw), out_path,
            platforms=[self.device.type] if platforms is None else platforms,
            device=self.device,
            meta={"kind": "ufldv1", "model": self.model_type.name},
        )

    def DetectFrame(self, image: np.ndarray, adjust_lanes: bool = False) -> None:
        """Detect lanes on one BGR uint8 frame; the result is
        :attr:`lane_info` (``lane_detector.py:453``)."""
        h, w = image.shape[:2]
        if self.engine is not None and getattr(self.engine, "fused", False):
            from ..engine.artifact import check_fused_frame

            loc = self.engine.run_device(check_fused_frame(self.engine, image)).cpu().numpy()[0]
        elif self.engine is not None:
            s = self.spec
            x = ufld_v1_preprocess(image, s.input_height, s.input_width, device=self.device)
            logits = self.engine.device_inference(x)[0]
            loc = ufld_v1_decode(logits.to(self.device, torch.float32)).cpu().numpy()[0]
        else:
            loc = self._step(frame_to_device(image, self.device)).cpu().numpy()[0]
        self.adjust_lanes = adjust_lanes
        self._assemble(loc, w, h)
        self._finalize(h)

    def _assemble(self, loc: np.ndarray, img_w: int, img_h: int) -> None:
        """The reference's point math on the (rows, lanes) grid locations
        (``lane_detector.py:476``)."""
        s = self.spec
        h_ratio, w_ratio = img_h / s.img_h, img_w / s.img_w
        col_sample_w = (s.input_width - 1) / (s.griding_num - 1)
        lanes_points, lanes_detected = [], []
        for lane in range(loc.shape[1]):
            pts = []
            if np.sum(loc[:, lane] != 0) > 2:
                lanes_detected.append(True)
                for k in range(loc.shape[0]):
                    if loc[k, lane] > 0:
                        x = loc[k, lane] * col_sample_w * s.img_w / s.input_width - 1
                        y = s.img_h * (s.row_anchor[s.cls_num_per_lane - 1 - k]
                                       / s.input_height) - 1
                        pts.append([int(x * w_ratio), int(y * h_ratio)])
            else:
                lanes_detected.append(False)
            lanes_points.append(pts)
        self.lane_info.lanes_points = np.array(lanes_points, dtype=object)
        self.lane_info.lanes_status = lanes_detected
