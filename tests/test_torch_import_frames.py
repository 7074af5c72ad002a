"""Nets loaded from torch checkpoints, through the facades, against the JAX
package's facades on the same checkpoint, on the CPU; and the weight
formats the port refuses where JAX runs an engine it does not have.

The three forwards of ``test_torch_frame.py``'s sizes: YOLOv8n at
320x320 (f32), UFLDv2 on the reduced CULane spec of
``test_torch_models`` and EfficientDet-D0 at 128x128 with zylo117's
90-way head, each from a ``.pth`` written under the released key names
(``tools/*_import``'s inverse mappings of a seeded flax tree) and read by
both packages' importers.  Bounds as in ``test_torch_frame.py``: the same
labels in the same order, boxes and confidences within 1e-4 relative;
lane points, lane status and the drivable area equal.  The ``.onnx`` of
the same initializers gives the port the same detections as the
``.pth``, to the bit.
"""
import numpy as np
import pytest
import torch

from adas_tpu.models import efficientdet as jax_effdet
from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.perception.efficientdet_detector import EfficientdetDetector as JaxEffdet
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.tools.yolo_import import yolo_variables as jax_yolo_variables
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.efficientdet import EfficientDetSpec
from adas_tpu_torch.models.yolo import YoloSpec
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.tools.efficientdet_import import efficientdet_state_dict
from adas_tpu_torch.tools.onnx_writer import save_model, simple_model
from adas_tpu_torch.tools.torch_import import ufld_state_dict
from adas_tpu_torch.tools.yolo_import import yolo_state_dict
from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType
from test_torch_efficientdet import live_trunk, random_tree
from test_torch_frame import (BOX_SCORE, EFFDET_SIZE, YOLO_HW, assert_same_objects, frames,
                              lanes, spread_yolo_scores)
from test_torch_models import SPEC_ARGS, random_flax_weights

CULANE = LaneModelType.UFLDV2_CULANE
JAX_CULANE = JaxLaneModelType.UFLDV2_CULANE


def save_pth(path, state):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, path)
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``.pth`` checkpoints (and YOLOv8n's ``.onnx``) of seeded trees,
    under the released names."""
    tmp = tmp_path_factory.mktemp("checkpoints")
    yolo = spread_yolo_scores(random_flax_weights(
        JaxYoloV8(JaxYoloSpec("v8", "n", 80, YOLO_HW)), (1, *YOLO_HW, 3), seed=31))
    yolo_state = yolo_state_dict(yolo, YoloSpec("n", 80, YOLO_HW, family="v8"))
    lane = random_flax_weights(JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)),
                               (1, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"], 3), seed=32)
    effdet = live_trunk(random_tree(
        jax_effdet.EfficientDet(jax_effdet.EfficientDetSpec(compound=0, num_classes=90)),
        [np.zeros((1, EFFDET_SIZE, EFFDET_SIZE, 3), np.float32)], seed=33))
    effdet["params::classifier::header::pw::kernel"] *= 5.0  # spread the class scores
    effdet["params::classifier::header::pw::bias"][:] = -2.0
    onnx = str(tmp / "yolov8n.onnx")
    save_model(onnx, simple_model([], [], [], initializers=yolo_state))
    return {
        "yolo": save_pth(str(tmp / "yolov8n.pth"), yolo_state),
        "yolo_onnx": onnx,
        "lane": save_pth(str(tmp / "culane.pth"), ufld_state_dict(lane)),
        "effdet": save_pth(str(tmp / "efficientdet-d0.pth"),
                           efficientdet_state_dict(effdet, EfficientDetSpec(0, 90))),
    }


@pytest.fixture(scope="module")
def reduced_culane():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_UFLD_SPECS, JAX_CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(port_ufld.UFLDV2_SPECS, CULANE, port_ufld.UFLDv2Spec(**SPEC_ARGS))
        yield


#: named on both sides: ``tests/test_yolo.py`` leaves JAX's ``YoloDetector``
#: class defaults at ``max_det`` 20 for the rest of its xdist worker
MAX_DET, NMS_IOU = 100, 0.45


def yolo_args(path, **kw):
    return dict(model_path=path, scale="n", input_size=YOLO_HW, box_score=BOX_SCORE,
                max_det=MAX_DET, box_nms_iou=NMS_IOU, **kw)


def test_yolo_pth_detect_frame_matches_jax(checkpoints):
    """YOLOv8n from the ``.pth`` in both packages; the port's ``.onnx`` of
    the same initializers detects the same, to the bit."""
    jyolo = JaxYolo(model_type=JaxObjectModelType.YOLOV8, **yolo_args(checkpoints["yolo"]))
    yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, device="cpu",
                        **yolo_args(checkpoints["yolo"]))
    onnx = YoloDetector(model_type=ObjectModelType.YOLOV8, device="cpu", onnx_mode="ingest",
                        **yolo_args(checkpoints["yolo_onnx"]))
    n = 0
    for f in frames(2, seed=1):
        jyolo.DetectFrame(f)
        yolo.DetectFrame(f)
        onnx.DetectFrame(f)
        n += assert_same_objects(jyolo.object_info, yolo.object_info)
        assert [(o.label, o.conf, o.tolist()) for o in onnx.object_info] == \
            [(o.label, o.conf, o.tolist()) for o in yolo.object_info]
    assert n > 0


def test_lane_pth_detect_frame_matches_jax(checkpoints, reduced_culane):
    jlane = JaxLane(model_path=checkpoints["lane"], model_type=JAX_CULANE)
    lane = UltrafastLaneDetectorV2(model_path=checkpoints["lane"], model_type=CULANE,
                                   device="cpu")
    for f in frames(2, seed=2):
        jlane.DetectFrame(f)
        lane.DetectFrame(f)
        assert lanes(lane.lane_info) == lanes(jlane.lane_info)


def test_efficientdet_pth_detect_frame_matches_jax(checkpoints):
    """EfficientDet-D0 from a zylo117-named ``.pth``: both facades take the
    head's width, 90 classes, from the checkpoint."""
    args = dict(model_path=checkpoints["effdet"], compound=0, input_size=EFFDET_SIZE,
                box_score=0.5)
    jdet, det = JaxEffdet(**args), EfficientdetDetector(device="cpu", **args)
    assert det.spec.num_classes == jdet.spec.num_classes == 90
    n = 0
    for f in frames(2, seed=6):
        jdet.DetectFrame(f)
        det.DetectFrame(f)
        n += assert_same_objects(jdet.object_info, det.object_info)
    assert n > 0


def test_engine_routes_raise(checkpoints, tmp_path):
    """Where JAX hands the model to its ONNX graph engine or a compiled
    artifact, so does the port, and each engine refuses these files as
    JAX's does, with the same exception type: an initializer-only
    ``.onnx`` has no graph input (``onnx_mode="graph"``, or ``"auto"``
    where the initializers do not map), a missing ``.adas`` is not found;
    ``onnx_mode="ingest"`` raises JAX's ``KeyError`` where the initializers
    do not map."""
    bad = str(tmp_path / "graph.onnx")
    save_model(bad, simple_model([], [], [], initializers={"layer0.w": np.ones(3, np.float32)}))
    adas = str(tmp_path / "model.adas")
    yolo = dict(model_type=ObjectModelType.YOLOV8, device="cpu")
    jyolo = dict(model_type=JaxObjectModelType.YOLOV8)

    def same_refusal(make_port, make_jax):
        with pytest.raises(Exception) as want:
            make_jax()
        with pytest.raises(type(want.value)):
            make_port()
        return want.type

    for path, kw in ((checkpoints["yolo_onnx"], {"onnx_mode": "graph"}), (bad, {}), (adas, {})):
        got = same_refusal(lambda: YoloDetector(**yolo, **yolo_args(path, **kw)),
                           lambda: JaxYolo(**jyolo, **yolo_args(path, **kw)))
        assert got is (FileNotFoundError if path == adas else ValueError)
    with pytest.raises(KeyError) as got:
        YoloDetector(**yolo, **yolo_args(bad, onnx_mode="ingest"))
    with pytest.raises(KeyError) as want:
        jax_yolo_variables({"layer0.w": np.ones(3, np.float32)},
                           JaxYoloSpec("v8", "n", 80, YOLO_HW))
    assert str(got.value) == str(want.value)
    for path in (bad, adas):
        same_refusal(lambda: UltrafastLaneDetectorV2(model_path=path, device="cpu"),
                     lambda: JaxLane(model_path=path,
                                     model_type=JaxLaneModelType.UFLDV2_CULANE))
    same_refusal(lambda: EfficientdetDetector(model_path=bad, device="cpu"),
                 lambda: JaxEffdet(model_path=bad))
    with pytest.raises(ValueError, match="Unsupported weights"):
        EfficientdetDetector(model_path=str(tmp_path / "model.adas"), device="cpu")
