"""The facades' engine seams against the JAX package's: ``engine=`` in
JAX's place in each ``__init__``, and the ``.onnx`` graph paths.

The graphs of ``tests/test_onnx_facade.py``, written here by the port's
``tools/onnx_writer``, go through both packages' facades (the port's on
the CPU): a v5-contract YOLO export whose initializers do not map
(``onnx_mode="auto"`` falls back to the graph executor, ``"graph"`` runs
it), a v5-lite pre-grid export, EfficientDet's postprocessed export, and
UFLD v2 and v1 exports returning seeded head outputs.  The detections are
the same (labels and integer boxes identical, scores within 1e-6), and so
are the lane points; a UFLDv2 graph of the wrong arity is refused by
both.  An injected ``FakeEngine`` runs the decode of its canned tensors,
and a ``TorchEngine`` over a facade's own net serves its native
detections; the port's engines take the facade's device blob
(``device_inference``), never the numpy round trip.
"""
import functools
import inspect

import numpy as np
import pytest

import test_onnx_facade as JT
from adas_tpu.perception.efficientdet_detector import EfficientdetDetector as JaxEffdet
from adas_tpu.perception.lane_detector import UltrafastLaneDetector as JaxLaneV1
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.engine.torch_engine import FakeEngine
from adas_tpu_torch.models.ufld import UFLDV1_SPECS, UFLDV2_SPECS
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.tools import onnx_writer as W
from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType

#: the port's extra constructor parameters, after JAX's (``compute_dtype``
#: is the port's name of the lane facades' ``dtype``)
PORT_EXTRAS = ("device", "seed", "backbone")


@pytest.mark.parametrize("port, jax", [
    (YoloDetector, JaxYolo), (EfficientdetDetector, JaxEffdet),
    (UltrafastLaneDetectorV2, JaxLane), (UltrafastLaneDetector, JaxLaneV1),
], ids=["yolo", "efficientdet", "ufldv2", "ufldv1"])
def test_signature_matches_jax(port, jax):
    """JAX's parameters, in its order, kinds and defaults (``engine=None``
    among them), then the port's own; a ``**kwargs`` stays last."""
    want = list(inspect.signature(jax.__init__).parameters.values())
    got = list(inspect.signature(port.__init__).parameters.values())
    assert "engine" in [p.name for p in want]
    named = [w for w in want if w.kind is not w.VAR_KEYWORD]
    for w, g in zip(named, got):
        assert g.name == ("compute_dtype" if w.name == "dtype" else w.name)
        assert g.kind == w.kind
        if w.name != "dtype":
            assert g.default == w.default, w.name
    extras = got[len(named):]
    if want[-1].kind is want[-1].VAR_KEYWORD:
        assert extras[-1].kind is extras[-1].VAR_KEYWORD
        extras = extras[:-1]
    assert {p.name for p in extras} <= set(PORT_EXTRAS)


@pytest.fixture
def port_writer(monkeypatch):
    """``test_onnx_facade``'s graph builders, writing with the port's writer."""
    monkeypatch.setattr(JT, "W", W)
    return JT


def _objects(det):
    return [(o.label, tuple(o.tolist(format_type="xywh")), o.conf) for o in det.object_info]


def _assert_same_objects(got, want):
    assert [(lab, box) for lab, box, _ in got] == [(lab, box) for lab, box, _ in want]
    np.testing.assert_allclose([c for *_, c in got], [c for *_, c in want], atol=1e-6)


@pytest.mark.parametrize("mode, mtype, frame_hw", [
    ("auto", "YOLOV7", (640, 640)),
    ("graph", "YOLOV5", (360, 640)),
])
def test_yolo_graph_matches_jax(port_writer, tmp_path, mode, mtype, frame_hw):
    path = port_writer._planted_yolo_onnx(tmp_path)
    det = YoloDetector(model_path=path, model_type=ObjectModelType[mtype], onnx_mode=mode,
                       box_score=0.4, device="cpu")
    jdet = JaxYolo(model_path=path, model_type=JaxObjectModelType[mtype], onnx_mode=mode,
                   box_score=0.4)
    assert det.engine.framework_type == "onnx-torch" and det.spec.input_size == (640, 640)
    frame = np.zeros((*frame_hw, 3), np.uint8)
    det.DetectFrame(frame)
    jdet.DetectFrame(frame)
    assert len(det.object_info) == 1
    _assert_same_objects(_objects(det), _objects(jdet))
    with pytest.raises((KeyError, NotImplementedError)):
        YoloDetector(model_path=path, model_type=ObjectModelType.YOLOV5, onnx_mode="ingest",
                     device="cpu")


def test_v5lite_pre_grid_export_matches_jax(port_writer, tmp_path, monkeypatch):
    """``test_onnx_facade``'s v5-lite export, grid-decoded once by each
    facade."""
    built = {}

    def capture(path, **kw):
        built["path"] = kw.get("model_path")
        raise _Stop

    class _Stop(Exception):
        pass

    monkeypatch.setattr(JT, "YoloDetector", lambda **kw: capture(None, **kw))
    with pytest.raises(_Stop):
        JT.TestV5LiteOnnxContract().test_pre_grid_export_grid_decodes(tmp_path)
    kw = dict(model_path=built["path"], box_score=0.4)
    det = YoloDetector(model_type=ObjectModelType.YOLOV5_LITE, device="cpu", **kw)
    jdet = JaxYolo(model_type=JaxObjectModelType.YOLOV5_LITE, **kw)
    frame = np.zeros((640, 640, 3), np.uint8)
    det.DetectFrame(frame)
    jdet.DetectFrame(frame)
    assert len(det.object_info) == 1
    _assert_same_objects(_objects(det), _objects(jdet))


def _effdet_onnx(tmp_path):
    boxes = np.array([[10, 20, 110, 220], [0, 0, 5, 5], [30, 40, 90, 120]], np.float32)
    nodes = [W.make_node("Identity", ["b0"], ["boxes"]),
             W.make_node("Identity", ["i0"], ["ids"]),
             W.make_node("Identity", ["c0"], ["confs"])]
    model = W.simple_model(
        nodes, [("input", np.float32, (1, 3, 512, 512))],
        [("boxes", np.float32, (3, 4)), ("ids", np.int64, (3,)), ("confs", np.float32, (3,))],
        initializers={"b0": boxes, "i0": np.array([2, 0, 7], np.int64),
                      "c0": np.array([0.9, 0.1, 0.7], np.float32)})
    path = tmp_path / "effdet_d0.onnx"
    path.write_bytes(model)
    return str(path)


def test_effdet_postprocessed_export_matches_jax(tmp_path):
    path = _effdet_onnx(tmp_path)
    det = EfficientdetDetector(model_path=path, box_score=0.6, device="cpu")
    jdet = JaxEffdet(model_path=path, box_score=0.6)
    assert det.engine.framework_type == "onnx-torch"
    assert tuple(det.input_shapes) == tuple(jdet.input_shapes) == (1, 3, 512, 512)
    for hw in ((512, 512), (360, 640)):
        frame = np.random.default_rng(1).integers(0, 255, (*hw, 3), dtype=np.uint8)
        det.DetectFrame(frame)
        jdet.DetectFrame(frame)
        assert len(det.object_info) == 2
        _assert_same_objects(_objects(det), _objects(jdet))


def _canned_lane_onnx(tmp_path, name, outputs, in_hw):
    nodes = [W.make_node("ReduceMean", ["input"], ["m"], keepdims=0),
             W.make_node("Mul", ["m", "zero"], ["z"])]
    inits = {"zero": np.float32(0.0)}
    for k, v in outputs.items():
        inits[f"c_{k}"] = v
        nodes.append(W.make_node("Add", [f"c_{k}", "z"], [k]))
    model = W.simple_model(nodes, [("input", np.float32, (1, 3, *in_hw))],
                           [(k, np.float32, v.shape) for k, v in outputs.items()],
                           initializers=inits)
    path = tmp_path / name
    path.write_bytes(model)
    return str(path)


def test_ufldv2_graph_matches_jax(tmp_path):
    """Seeded head outputs with a few confident lanes, decoded by both."""
    s = UFLDV2_SPECS[LaneModelType.UFLDV2_TUSIMPLE]
    rng = np.random.default_rng(7)
    outs = {
        "loc_row": rng.standard_normal((1, s.num_cell_row, s.num_row, 4)).astype(np.float32),
        "loc_col": rng.standard_normal((1, s.num_cell_col, s.num_col, 4)).astype(np.float32),
        "exist_row": rng.standard_normal((1, 2, s.num_row, 4)).astype(np.float32),
        "exist_col": rng.standard_normal((1, 2, s.num_col, 4)).astype(np.float32),
    }
    outs["exist_row"][:, 1, :, 1:3] += 3.0
    outs["loc_row"][:, 30, :, 1] += 6.0
    outs["loc_row"][:, 60, :, 2] += 6.0
    path = _canned_lane_onnx(tmp_path, "ufldv2.onnx", outs, (s.input_height, s.input_width))
    det = UltrafastLaneDetectorV2(model_path=path, model_type=LaneModelType.UFLDV2_TUSIMPLE,
                                  device="cpu")
    jdet = JaxLane(model_path=path, model_type=JaxLaneModelType.UFLDV2_TUSIMPLE)
    assert det.engine.framework_type == "onnx-torch"
    frame = rng.integers(0, 255, (240, 480, 3), dtype=np.uint8)
    det.DetectFrame(frame)
    jdet.DetectFrame(frame)
    assert det.lane_info.lanes_status == jdet.lane_info.lanes_status
    assert sum(det.lane_info.lanes_status) >= 2
    assert [list(map(tuple, p)) for p in det.lane_info.lanes_points] == \
        [list(map(tuple, p)) for p in jdet.lane_info.lanes_points]


def test_ufldv1_graph_matches_jax(tmp_path):
    s = UFLDV1_SPECS[LaneModelType.UFLD_TUSIMPLE]
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((1, s.griding_num + 1, s.cls_num_per_lane, 4))
    logits[:, 20, :, 1] += 8.0
    logits[:, 70, :, 2] += 8.0
    path = _canned_lane_onnx(tmp_path, "ufldv1.onnx", {"output": logits.astype(np.float32)},
                             (s.input_height, s.input_width))
    det = UltrafastLaneDetector(model_path=path, model_type=LaneModelType.UFLD_TUSIMPLE,
                                device="cpu")
    jdet = JaxLaneV1(model_path=path, model_type=JaxLaneModelType.UFLD_TUSIMPLE)
    frame = rng.integers(0, 255, (240, 480, 3), dtype=np.uint8)
    det.DetectFrame(frame)
    jdet.DetectFrame(frame)
    assert det.lane_info.lanes_status == jdet.lane_info.lanes_status
    assert sum(det.lane_info.lanes_status) >= 2
    assert [list(map(tuple, p)) for p in det.lane_info.lanes_points] == \
        [list(map(tuple, p)) for p in jdet.lane_info.lanes_points]


def test_wrong_output_arity_rejected(tmp_path):
    path = _canned_lane_onnx(tmp_path, "bad.onnx", {"out": np.zeros((1, 4), np.float32)},
                             (320, 800))
    with pytest.raises(ValueError, match="4 tensors"):
        UltrafastLaneDetectorV2(model_path=path, model_type=LaneModelType.UFLDV2_TUSIMPLE,
                                device="cpu")
    with pytest.raises(ValueError, match="4 tensors"):
        JaxLane(model_path=path, model_type=JaxLaneModelType.UFLDV2_TUSIMPLE)


def test_injected_engine_decodes_its_outputs():
    """``engine=`` replaces the net: a ``FakeEngine``'s planted v8-contract
    row is decoded, selected and un-letterboxed on the device; a string
    is not an engine."""
    raw = np.zeros((1, 84, 10), np.float32)
    raw[0, :4, 3] = [80, 80, 40, 20]
    raw[0, 4 + 5, 3] = 0.9
    eng = FakeEngine((1, 3, 160, 160), {"output0": raw})
    det = YoloDetector(engine=eng, model_type=ObjectModelType.YOLOV8, device="cpu")
    assert det.spec.input_size == (160, 160) and det.output_names == ["output0"]
    det.DetectFrame(np.zeros((160, 160, 3), np.uint8))
    assert len(eng.calls) == 1 and eng.calls[0].shape == (1, 3, 160, 160)
    (obj,) = det.object_info
    assert obj.label == det.class_names[5] and obj.tolist(format_type="xywh") == [60, 70, 40, 20]
    with pytest.raises(TypeError, match="EngineBase"):
        YoloDetector(engine="graph", device="cpu")


def test_torch_engine_serves_the_native_net():
    """``TorchEngine`` (the port's ``XLAEngine``) wrapping a facade's own net,
    injected with ``engine=``: the engine path's detections equal the native
    step's, and the engine reports JAX's shapes and names."""
    from adas_tpu_torch.engine.torch_engine import TorchEngine

    native = YoloDetector(model_type=ObjectModelType.YOLOV8, input_size=(64, 64),
                          box_score=0.05, device="cpu")
    eng = TorchEngine(lambda net, x: net(x.permute(0, 3, 1, 2)), native.net, (1, 3, 64, 64),
                      ["output0"], aot=True, device="cpu")
    assert eng.get_engine_output_shape() == ([(1, 84, 84)], ["output0"])
    det = YoloDetector(engine=eng, model_type=ObjectModelType.YOLOV8, box_score=0.05,
                       device="cpu")
    frame = np.random.default_rng(2).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    native.DetectFrame(frame)
    det.DetectFrame(frame)
    assert len(det.object_info) > 0
    assert [(o.label, o.conf, o.tolist()) for o in det.object_info] == \
        [(o.label, o.conf, o.tolist()) for o in native.object_info]


def _no_host_round_trip(*_):
    raise AssertionError("the facade copied the blob through engine_inference")


@pytest.mark.parametrize("kind", ["torch", "onnx"])
def test_port_engines_keep_the_blob_on_the_device(port_writer, tmp_path, monkeypatch, kind):
    """The facades hand the port's engines the device blob
    (``device_inference``): ``engine_inference``, the numpy round trip an
    engine without a device path takes, is never called, and the
    detections are those of the numpy route."""
    from adas_tpu_torch.engine.base import EngineBase
    from adas_tpu_torch.engine.torch_engine import TorchEngine

    frame = np.random.default_rng(4).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    if kind == "torch":
        native = YoloDetector(model_type=ObjectModelType.YOLOV8, input_size=(64, 64),
                              box_score=0.05, device="cpu")
        eng = TorchEngine(lambda net, x: net(x.permute(0, 3, 1, 2)), native.net,
                          (1, 3, 64, 64), ["output0"], aot=True, device="cpu")
        det = YoloDetector(engine=eng, model_type=ObjectModelType.YOLOV8, box_score=0.05,
                           device="cpu")
    else:
        det = YoloDetector(model_path=port_writer._planted_yolo_onnx(tmp_path),
                           model_type=ObjectModelType.YOLOV5, onnx_mode="graph", box_score=0.4,
                           device="cpu")
        frame = np.zeros((360, 640, 3), np.uint8)
    eng = det.engine
    # the numpy route: the base class's device_inference, through engine_inference
    eng.device_inference = functools.partial(EngineBase.device_inference, eng)
    det.DetectFrame(frame)
    want = _objects(det)
    del eng.device_inference
    monkeypatch.setattr(eng, "engine_inference", _no_host_round_trip)
    det.DetectFrame(frame)
    assert len(want) > 0 and _objects(det) == want
