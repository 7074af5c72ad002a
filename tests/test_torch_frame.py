"""The port's single-frame path against the JAX package: ``DetectFrame``
of both facades and ``FusedADASStep``, on the CPU.

The pair of ``tests/test_fused.py``: YOLOv8n at 320x320 and
UFLDv2-TuSimple (ResNet-18, 320x800, the full spec) on 360x640 frames,
plus UFLDv2 on the reduced CULane spec of ``test_torch_slice.py`` and
EfficientDet-D0 at 128x128 on the object side; the same weights on both
sides (one ``params_io`` ``.npz`` per net, random from a numpy seed).  The
JAX stems run their parity-pinned XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``),
the port's their plain CPU version.

Bounds (f32): detections with the same labels in the same order, boxes
and confidences within 1e-4 relative (boxes: of the frame's width); lane
points, lane status and the drivable area equal.  The calibrated int8
``DetectFrame`` is matched as ``test_torch_int8_slice.py`` matches the
int8 slice, on its weights and calibration.
"""
import jax.numpy as jnp
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
from adas_tpu.pipeline.fused import FusedADASStep as JaxFused
from adas_tpu.tools.params_io import save_params, unflatten_variables
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.fused import FusedADASStep
from adas_tpu_torch.utils.types import LaneModelType
from test_torch_efficientdet import live_trunk, random_tree
from test_torch_int8_slice import _matched, calibrated, npz_paths
from test_torch_models import SPEC_ARGS, random_flax_weights
from test_torch_slice import YOLO_HW as INT8_YOLO_HW

__all__ = ["calibrated", "npz_paths"]  # the int8 slice's weights and calibration

FRAME_HW = (360, 640)
YOLO_HW = (320, 320)
BOX_SCORE = 0.25
EFFDET_SIZE = 128
LANES = {"tusimple": LaneModelType.UFLDV2_TUSIMPLE, "culane": LaneModelType.UFLDV2_CULANE}
JAX_LANES = {"tusimple": JaxLaneModelType.UFLDV2_TUSIMPLE,
             "culane": JaxLaneModelType.UFLDV2_CULANE}


def spread_yolo_scores(flat):
    """The weight tweak of ``test_torch_slice.py``: a 1.5x kernel gain keeps
    a random deep SiLU net's scores content-driven, and a wide, negatively
    biased class predictor spreads them, so that the order of the
    detections is not f32 noise."""
    for k in flat:
        if k.endswith("kernel") and not k.endswith("_2::kernel"):
            flat[k] *= 1.5
        elif "::cls" in k and k.endswith("_2::kernel"):
            flat[k] *= 10.0
        elif "::cls" in k and k.endswith("_2::bias"):
            flat[k][:] = -5.0
    return flat


@pytest.fixture(scope="module")
def frame_weights(tmp_path_factory):
    """One params_io .npz per net: YOLOv8n-320, UFLDv2-TuSimple (full
    spec), UFLDv2 on the reduced CULane spec, EfficientDet-D0-128."""
    tmp = tmp_path_factory.mktemp("frame_weights")
    tus = JAX_UFLD_SPECS[JaxLaneModelType.UFLDV2_TUSIMPLE]
    effdet = jax_effdet.EfficientDet(jax_effdet.EfficientDetSpec(compound=0, num_classes=80))
    flats = {
        "yolo": spread_yolo_scores(random_flax_weights(
            JaxYoloV8(JaxYoloSpec("v8", "n", 80, YOLO_HW)), (1, *YOLO_HW, 3), seed=21)),
        "tusimple": random_flax_weights(
            JaxUFLDv2Net(tus), (1, tus.input_height, tus.input_width, 3), seed=22),
        "culane": random_flax_weights(
            JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)),
            (1, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"], 3), seed=23),
        "effdet": live_trunk(random_tree(
            effdet, [jnp.zeros((1, EFFDET_SIZE, EFFDET_SIZE, 3))], seed=24)),
    }
    # as test_torch_effdet_slice.py: spread the class scores
    flats["effdet"]["params::classifier::header::pw::kernel"] *= 5.0
    flats["effdet"]["params::classifier::header::pw::bias"][:] = -2.0
    paths = {}
    for name, flat in flats.items():
        paths[name] = str(tmp / f"{name}.npz")
        save_params(paths[name], unflatten_variables(flat))
    return paths


@pytest.fixture
def weights(frame_weights, monkeypatch):
    """The reduced CULane spec on both sides, the JAX stems' XLA chain, and
    the weight files."""
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    monkeypatch.setitem(JAX_UFLD_SPECS, JaxLaneModelType.UFLDV2_CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
    monkeypatch.setitem(
        port_ufld.UFLDV2_SPECS, LaneModelType.UFLDV2_CULANE, port_ufld.UFLDv2Spec(**SPEC_ARGS),
    )
    return frame_weights


def frames(n, seed=0, hw=FRAME_HW):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def yolo_pair(weights, **kw):
    """The JAX and the port's YOLOv8n-320 facades on the same weights."""
    args = dict(model_path=weights["yolo"], scale="n", input_size=YOLO_HW, box_score=BOX_SCORE, **kw)
    return (JaxYolo(model_type=JaxObjectModelType.YOLOV8, **args),
            YoloDetector(device="cpu", **args))


def lane_pair(weights, name="tusimple"):
    return (JaxLane(model_path=weights[name], model_type=JAX_LANES[name]),
            UltrafastLaneDetectorV2(model_path=weights[name], model_type=LANES[name], device="cpu"))


def rows(objs):
    """Labels, (N, 4) xyxy boxes and confidences of ``RectInfo`` rows."""
    return ([o.label for o in objs],
            np.array([[o.x, o.y, o.x + o.width, o.y + o.height] for o in objs]).reshape(-1, 4),
            np.array([o.conf for o in objs]))


def assert_same_objects(want, got):
    wl, wb, ws = rows(want)
    gl, gb, gs = rows(got)
    assert gl == wl
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4 * FRAME_HW[1])
    np.testing.assert_allclose(gs, ws, rtol=1e-4)
    return len(gl)


def lanes(info):
    """Lane points, lane status, drivable-area status and polygon."""
    return ([[tuple(map(int, p)) for p in pts] for pts in info.lanes_points],
            list(info.lanes_status), info.area_status,
            np.asarray(info.area_points, np.float64).tolist())


def test_yolo_detect_frame_matches_jax(weights):
    jyolo, yolo = yolo_pair(weights)
    n = 0
    for f in frames(2, seed=1):
        jyolo.DetectFrame(f)
        yolo.DetectFrame(f)
        n += assert_same_objects(jyolo.object_info, yolo.object_info)
    assert n > 0 and len(yolo._steps) == 1  # one step per source shape


@pytest.mark.parametrize("name", ["tusimple", "culane"])
@pytest.mark.parametrize("adjust_lanes", [False, True])
def test_lane_detect_frame_matches_jax(weights, name, adjust_lanes):
    jlane, lane = lane_pair(weights, name)
    for f in frames(2, seed=2):
        jlane.DetectFrame(f, adjust_lanes=adjust_lanes)
        lane.DetectFrame(f, adjust_lanes=adjust_lanes)
        assert lanes(lane.lane_info) == lanes(jlane.lane_info)
    assert len(lane.lane_info.lanes_status) == 4


def test_fused_matches_separate_paths(weights):
    """The port's ``FusedADASStep.run`` populates both facades exactly as
    their own ``DetectFrame`` does (``tests/test_fused.py``)."""
    _, yolo = yolo_pair(weights)
    _, lane = lane_pair(weights)
    fused = FusedADASStep(yolo, lane)
    for f in frames(2, seed=3):
        fused.run(f)
        fused_objs = [(o.label, o.conf, o.tolist()) for o in yolo.object_info]
        fused_lanes = lanes(lane.lane_info)
        yolo.DetectFrame(f)
        lane.DetectFrame(f)
        assert fused_objs == [(o.label, o.conf, o.tolist()) for o in yolo.object_info]
        assert fused_lanes == lanes(lane.lane_info)
    assert fused_objs


def test_fused_pipelined_ordering(weights):
    """Submitting frame i+1 before fetching frame i gives each frame's
    result in order (``tests/test_fused.py``)."""
    _, yolo = yolo_pair(weights)
    _, lane = lane_pair(weights, "culane")
    fused = FusedADASStep(yolo, lane, transport="i420")
    fs = frames(3, seed=4)
    expected = []
    for f in fs:
        fused.run(f)
        expected.append(([(o.label, o.conf) for o in yolo.object_info], lanes(lane.lane_info)))
    got = []
    pending = fused.submit(fs[0])
    for f in fs[1:] + [None]:
        nxt = fused.submit(f) if f is not None else None
        fused.fetch(pending)
        got.append(([(o.label, o.conf) for o in yolo.object_info], lanes(lane.lane_info)))
        pending = nxt
    assert got == expected


@pytest.mark.parametrize("transport", ["bgr", "i420"])
def test_fused_matches_jax(weights, transport):
    """``FusedADASStep`` with each transport against JAX's: on I420 both
    preprocess YUV-direct (the JAX planes path)."""
    jyolo, yolo = yolo_pair(weights)
    jlane, lane = lane_pair(weights)
    jfused = JaxFused(jyolo, jlane, transport=transport)
    fused = FusedADASStep(yolo, lane, transport=transport)
    n = 0
    for f in frames(2, seed=5):
        jfused.run(f)
        fused.run(f)
        n += assert_same_objects(jyolo.object_info, yolo.object_info)
        assert lanes(lane.lane_info) == lanes(jlane.lane_info)
    assert n > 0


@pytest.mark.parametrize("transport", ["bgr", "i420"])
def test_fused_efficientdet_matches_jax(weights, transport):
    """The EfficientDet-D0 object side (``fused.py:77-84``): BGR frames in
    colour; on I420 gray frames, since the jitted JAX decode of coloured
    I420 contracts into FMAs one level off the formula
    (``test_torch_effdet_slice.py``)."""
    args = dict(model_path=weights["effdet"], compound=0, input_size=EFFDET_SIZE, box_score=0.5)
    jdet, det = JaxEffdet(**args), EfficientdetDetector(device="cpu", **args)
    jlane, lane = lane_pair(weights, "culane")
    jfused = JaxFused(jdet, jlane, transport=transport)
    fused = FusedADASStep(det, lane, transport=transport)
    n = 0
    for f in frames(2, seed=6):
        if transport == "i420":
            f = np.repeat(f[..., :1], 3, axis=-1)
        jfused.run(f)
        fused.run(f)
        n += assert_same_objects(jdet.object_info, det.object_info)
        assert lanes(lane.lane_info) == lanes(jlane.lane_info)
    assert n > 0


def test_host_downscale_and_transport_raise(weights):
    _, yolo = yolo_pair(weights)
    _, lane = lane_pair(weights, "culane")
    with pytest.raises(NotImplementedError, match="host_downscale"):
        FusedADASStep(yolo, lane, host_downscale=(180, 320))
    with pytest.raises(ValueError, match="transport"):
        FusedADASStep(yolo, lane, transport="nv12")


def test_int8_detect_frame_close_to_jax(calibrated):
    """Calibrated int8 ``DetectFrame`` on the int8 slice's weights and
    calibration (YOLOv8n-160, reduced CULane; the fixture holds the
    reduced spec and the JAX stems' XLA chain): the JAX facade feeds both
    nets f32 here (``object_detector.py:383-386``), as the port does.
    Bounds of ``test_torch_int8_slice.py``, per frame: detection counts
    within 20% (+2); at least half of the port's detections matched by a
    JAX one (same label, IoU > 0.5, score within 0.05); detected lanes
    within 1."""
    jyolo, jlane, paths, _ = calibrated
    yolo = YoloDetector(model_path=paths["yolo"], scale="n", input_size=INT8_YOLO_HW,
                        box_score=0.25, compute_dtype="int8", device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype="int8", device="cpu")
    n = 0
    for f in frames(2, seed=7, hw=(180, 320)):
        for facade in (jyolo, yolo, jlane, lane):
            facade.DetectFrame(f)
        wl, wb, ws = rows(jyolo.object_info)
        gl, gb, gs = rows(yolo.object_info)
        assert abs(len(gl) - len(wl)) <= 0.2 * len(wl) + 2
        assert np.all(np.isfinite(gb)) and np.all((gs > 0.25) & (gs <= 1))
        assert sum(_matched(b, lab, sc, wb, wl, ws) for lab, b, sc in zip(gl, gb, gs)) \
            >= 0.5 * len(gl)
        assert abs(sum(lane.lane_info.lanes_status) - sum(jlane.lane_info.lanes_status)) <= 1
        n += len(gl)
    assert n > 0


def test_int8_head_at_one_row_matches_batched(calibrated):
    """``Int8Dense`` at M = 1 (``torch._int_mm`` padded to 32 rows): the
    int8 lane net on one frame gives the rows it gives in a batch of two."""
    _, _, paths, _ = calibrated
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype="int8", device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"])).astype(np.float32))
    with torch.inference_mode():
        both = lane.net(x)
        one = [lane.net(x[i: i + 1]) for i in range(2)]
    for k, v in both.items():
        for i in range(2):
            torch.testing.assert_close(one[i][k][0], v[i], rtol=0, atol=0)
