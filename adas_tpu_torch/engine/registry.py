"""Model registry: one place that maps a model-type name to a built net and
its canonical input shape (the port's copy of
``adas_tpu/engine/registry.py``).

Registered names are the JAX registry's: the reference's enum vocabulary
(every YOLO family, UFLD v1/v2 with CurveLanes) plus EfficientDet, with
the same ``input_shape_nchw``.  Precision is a constructor argument of the
port's nets, so each build function also takes ``int8`` (the JAX
registry's build functions ignore unknown keywords and its nets take the int8 mode from a
context).  A built net holds torch's default init: its weights come from
``weights.init_params`` or ``weights.load_flax_variables``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelEntry:
    """A built net: torch module + NCHW input shape + metadata."""

    net: object
    input_shape_nchw: Tuple[int, int, int, int]
    meta: dict


_BUILDERS: Dict[str, Callable[..., ModelEntry]] = {}


def register(name: str):
    def deco(fn):
        _BUILDERS[name.upper()] = fn
        return fn

    return deco


def available() -> list:
    return sorted(_BUILDERS)


def build(name: str, **kwargs) -> ModelEntry:
    """Build a registered model; kwargs go to its build function (scale=,
    height=, width=, num_classes=, compound=, int8=...)."""
    key = name.upper()
    if key not in _BUILDERS:
        raise KeyError(
            f"unknown model '{name}'; available: {', '.join(available())}"
        )
    return _BUILDERS[key](**kwargs)


def _yolo(family: str, name: str):
    @register(name)
    def _build(
        scale: str = "n",
        height: int = 640,
        width: int = 640,
        num_classes: int = 80,
        int8: bool = False,
        **_,
    ) -> ModelEntry:
        from ..models.yolo import YoloSpec, build_yolo

        spec = YoloSpec(
            family=family, scale=scale, num_classes=num_classes,
            input_size=(height, width),
        )
        return ModelEntry(
            net=build_yolo(spec, int8=int8),
            input_shape_nchw=(1, 3, height, width),
            meta={"model": name, "scale": scale, "family": family},
        )

    return _build


for _name, _family in (
    ("YOLOV5", "v5"), ("YOLOV5_LITE", "v5lite"), ("YOLOV6", "v6"),
    ("YOLOV7", "v7"), ("YOLOV8", "v8"), ("YOLOV9", "v9"),
    ("YOLOV10", "v10"),
):
    _yolo(_family, _name)


@register("EFFICIENTDET")
def _efficientdet(
    compound: int = 0, num_classes: int = 90, scale: Optional[str] = None,
    int8: bool = False, **_
) -> ModelEntry:
    from ..models.efficientdet import EfficientDet, EfficientDetSpec

    if scale is not None:
        compound = int(scale)
    spec = EfficientDetSpec(compound=compound, num_classes=num_classes)
    s = spec.input_size
    return ModelEntry(
        net=EfficientDet(spec, int8=int8),
        input_shape_nchw=(1, 3, s, s),
        meta={"model": "EFFICIENTDET", "compound": compound},
    )


def _ufld(name: str):
    @register(name)
    def _build(int8: bool = False, **_) -> ModelEntry:
        from ..models.ufld import (
            UFLDV1_SPECS,
            UFLDV2_SPECS,
            UFLDv1Net,
            UFLDv2CurveLanesNet,
            UFLDv2Net,
        )
        from ..utils.types import LaneModelType

        lane_type = LaneModelType[name]
        if "V2" in name:
            spec = UFLDV2_SPECS[lane_type]
            if name == "UFLDV2_CURVELANES":
                # the 20-lane-token conv head; the facades serve CurveLanes
                # through UFLDv2Net
                if int8:
                    raise ValueError("UFLDV2_CURVELANES is built in f32 only")
                net = UFLDv2CurveLanesNet(spec)
            else:
                net = UFLDv2Net(spec, int8=int8)
        else:
            spec = UFLDV1_SPECS[lane_type]
            net = UFLDv1Net(spec, int8=int8)
        return ModelEntry(
            net=net,
            input_shape_nchw=(1, 3, spec.input_height, spec.input_width),
            meta={"model": name},
        )

    return _build


for _name in (
    "UFLD_TUSIMPLE", "UFLD_CULANE",
    "UFLDV2_TUSIMPLE", "UFLDV2_CULANE", "UFLDV2_CURVELANES",
):
    _ufld(_name)
