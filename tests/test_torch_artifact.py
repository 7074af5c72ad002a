"""The port's ``.adas`` artifacts of the single-frame facades
(``engine/artifact.py``, ``export_fused``) against its native steps and
the JAX package's artifacts of the same configuration.

YOLOv8n at 160x160 and UFLDv2 on the reduced CULane spec (the weights
of ``test_torch_slice``), YOLOv8n in one multi-geometry file of 180x320
and 90x160 frames, and UFLD v1-TuSimple at a 64x160 input with a 64-wide
MLP (``test_torch_lane_families``'s cut), random weights from a numpy
seed, one ``params_io`` ``.npz`` per net loaded by both packages; the JAX
stems run their XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``).  One JAX export
per facade is shared by the module.

* Served through ``DetectFrame``, each artifact equals the port's native
  step to the bit, on every geometry; another frame shape raises.
* It equals JAX's ``.adas`` within ``test_torch_slice``'s bounds: labels
  identical, boxes within 1e-2 px, scores within 1e-4, lane points
  identical.
* ``meta.json`` equals JAX's (both exported for the CPU); the program
  files are the port's ``.pt2`` where JAX's are ``.bin``.
* A calibrated int8 YOLOv8n's program holds one ``int8_conv`` node per
  int8 conv of the net, and serves the native bits.
* Refusals: a JAX ``.adas``, another device type, and ``export_fused`` or
  calibration on an engine-served facade.
"""
import dataclasses
import json
import zipfile

import numpy as np
import pytest

from adas_tpu.models import ufld as jax_ufld
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.engine.artifact import CompiledEngine, read_meta
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.quant import QConv2d
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType
from test_torch_models import SPEC_ARGS, random_flax_weights, save_npz
from test_torch_slice import YOLO_HW, npz_paths, signal

__all__ = ["npz_paths"]  # the slice tests' weights

GEOMS = [(180, 320), (90, 160)]
V1_SPEC = dict(input_height=64, input_width=160, mlp_mid=64)


def _frames(hw, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def int8_conv_nodes(path: str) -> int:
    """``int8_conv`` nodes across the programs of a ``.adas`` file."""
    eng = CompiledEngine(path, device="cpu")
    return sum(str(n.target) == "adas_tpu_torch.int8_conv.default"
               for m in eng._calls.values() for n in m.graph.nodes)


@pytest.fixture(scope="module")
def exported(npz_paths, tmp_path_factory):
    """Both packages' facades on the same weights, and their fused
    artifacts (JAX's exported once for the module)."""
    tmp = tmp_path_factory.mktemp("artifacts")
    yolo_kw = dict(model_path=npz_paths["yolo"], scale="n", input_size=YOLO_HW, box_score=0.25)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
        mp.setitem(jax_ufld.UFLDV1_SPECS, JaxLaneModelType.UFLD_TUSIMPLE,
                   dataclasses.replace(
                       jax_ufld.UFLDV1_SPECS[JaxLaneModelType.UFLD_TUSIMPLE], **V1_SPEC))
        mp.setitem(port_ufld.UFLDV1_SPECS, LaneModelType.UFLD_TUSIMPLE,
                   dataclasses.replace(
                       port_ufld.UFLDV1_SPECS[LaneModelType.UFLD_TUSIMPLE], **V1_SPEC))
        mp.setitem(jax_ufld.UFLDV2_SPECS, JaxLaneModelType.UFLDV2_CULANE,
                   jax_ufld.UFLDv2Spec(**SPEC_ARGS))
        mp.setitem(port_ufld.UFLDV2_SPECS, LaneModelType.UFLDV2_CULANE,
                   port_ufld.UFLDv2Spec(**SPEC_ARGS))
        lanes = {"v2": npz_paths["lane"], "v1": str(tmp / "lane_v1.npz")}
        jnet = jax_ufld.UFLDv1Net(jax_ufld.UFLDV1_SPECS[JaxLaneModelType.UFLD_TUSIMPLE])
        save_npz(lanes["v1"], unflatten_variables(random_flax_weights(jnet, (1, 64, 160, 3), 7)))
        out = {
            "yolo": (YoloDetector(model_type=ObjectModelType.YOLOV8, device="cpu", **yolo_kw),
                     JaxYolo(model_type=JaxObjectModelType.YOLOV8, **yolo_kw), GEOMS),
            "v2": (UltrafastLaneDetectorV2(lanes["v2"], LaneModelType.UFLDV2_CULANE,
                                           device="cpu"),
                   JaxLane(lanes["v2"], JaxLaneModelType.UFLDV2_CULANE), GEOMS[:1]),
            "v1": (UltrafastLaneDetector(lanes["v1"], LaneModelType.UFLD_TUSIMPLE, device="cpu"),
                   None, GEOMS[:1]),
        }
        paths = {}
        for name, (port, jax, geoms) in out.items():
            paths[name] = str(tmp / f"{name}.adas")
            port.export_fused(paths[name], geoms)
            if jax is not None:
                paths["jax_" + name] = str(tmp / f"jax_{name}.adas")
                jax.export_fused(paths["jax_" + name], geoms, platforms=["cpu"])
        served = {
            "yolo": YoloDetector(model_type=ObjectModelType.YOLOV8, device="cpu",
                                 **{**yolo_kw, "model_path": paths["yolo"]}),
            "jax_yolo": JaxYolo(model_type=JaxObjectModelType.YOLOV8,
                                **{**yolo_kw, "model_path": paths["jax_yolo"]}),
            "v2": UltrafastLaneDetectorV2(paths["v2"], LaneModelType.UFLDV2_CULANE, device="cpu"),
            "jax_v2": JaxLane(paths["jax_v2"], JaxLaneModelType.UFLDV2_CULANE),
            "v1": UltrafastLaneDetector(paths["v1"], LaneModelType.UFLD_TUSIMPLE, device="cpu"),
        }
        yield out, paths, served


def _objects(det):
    objs = det.object_info
    return ([o.label for o in objs],
            np.array([[o.x, o.y, o.x + o.width, o.y + o.height] for o in objs]).reshape(-1, 4),
            np.array([o.conf for o in objs]))


def _lanes(det):
    return [list(p) for p in det.lane_info.lanes_points], list(det.lane_info.lanes_status)


def test_yolo_artifact_equals_native(exported):
    out, _, served = exported
    native, eng = out["yolo"][0], served["yolo"]
    assert eng.engine.fused and eng.engine.fused_shapes == {(*hw, 3) for hw in GEOMS}
    n = 0
    for hw in GEOMS:
        for f in _frames(hw):
            native.DetectFrame(f)
            eng.DetectFrame(f)
            got, want = _objects(eng), _objects(native)
            assert got[0] == want[0]
            assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
            n += len(got[0])
    assert n > 0
    with pytest.raises(ValueError, match="fused engine was built"):
        eng.DetectFrame(_frames((100, 176), 1)[0])


@pytest.mark.parametrize("name", ["v2", "v1"])
def test_lane_artifact_equals_native(exported, name):
    out, _, served = exported
    native, eng = out[name][0], served[name]
    assert eng.engine.fused
    for f in _frames(GEOMS[0], seed=3):
        native.DetectFrame(f)
        eng.DetectFrame(f)
        assert _lanes(eng) == _lanes(native)


def test_yolo_artifact_close_to_jax(exported):
    _, _, served = exported
    port, jax = served["yolo"], served["jax_yolo"]
    n = 0
    for hw in GEOMS:
        for f in _frames(hw, seed=1):
            jax.DetectFrame(f)
            port.DetectFrame(f)
            (gl, gb, gs), (wl, wb, ws) = _objects(port), _objects(jax)
            assert gl == wl
            np.testing.assert_allclose(gb, wb, atol=1e-2)
            np.testing.assert_allclose(gs, ws, atol=1e-4)
            n += len(gl)
    assert n > 0


def test_lane_artifact_close_to_jax(exported):
    _, _, served = exported
    for f in _frames(GEOMS[0], seed=4):
        served["jax_v2"].DetectFrame(f)
        served["v2"].DetectFrame(f)
        want_pts, want_status = _lanes(served["jax_v2"])
        got_pts, got_status = _lanes(served["v2"])
        assert got_status == want_status
        assert [[tuple(p) for p in lane] for lane in got_pts] == \
            [[tuple(p) for p in lane] for lane in want_pts]
        assert signal(served["v2"].lane_info.area_status) == \
            signal(served["jax_v2"].lane_info.area_status)


@pytest.mark.parametrize("name", ["yolo", "v2"])
def test_meta_matches_jax(exported, name):
    _, paths, _ = exported
    assert read_meta(paths[name]) == read_meta(paths["jax_" + name])
    with zipfile.ZipFile(paths[name]) as a, zipfile.ZipFile(paths["jax_" + name]) as b:
        names = sorted(a.namelist())
        assert [n.replace(".pt2", ".bin") for n in names] == sorted(b.namelist())


def test_int8_artifact_holds_every_int8_conv(tmp_path):
    """A calibrated int8 YOLOv8n: one ``int8_conv`` node per int8 conv in
    each geometry's program, and the native bits served."""
    det = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=YOLO_HW,
                       box_score=0.05, compute_dtype="int8", device="cpu")
    frames = _frames(GEOMS[0], seed=5)
    det.calibrate_int8(frames)
    path = str(tmp_path / "int8.adas")
    det.export_fused(path, GEOMS[:1])
    n_convs = sum(isinstance(m, QConv2d) for m in det.net.modules())
    assert n_convs > 50 and int8_conv_nodes(path) == n_convs
    served = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=YOLO_HW,
                          box_score=0.05, model_path=path, device="cpu")
    for f in frames:
        det.DetectFrame(f)
        served.DetectFrame(f)
        assert [(o.label, o.conf, o.tolist()) for o in served.object_info] == \
            [(o.label, o.conf, o.tolist()) for o in det.object_info]


def test_refusals(exported, tmp_path):
    """A JAX ``.adas`` names its format; an artifact exported for another
    device type refuses this one; an engine-served facade neither exports
    nor calibrates."""
    out, paths, served = exported
    with pytest.raises(ValueError, match="JAX .adas"):
        CompiledEngine(paths["jax_yolo"], device="cpu")
    cuda = str(tmp_path / "cuda.adas")
    with zipfile.ZipFile(paths["v2"]) as src, zipfile.ZipFile(cuda, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), "platforms": ["cuda"]})
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="exported for \\['cuda'\\]"):
        CompiledEngine(cuda, device="cpu")
    for det in (served["yolo"], served["v2"], served["v1"]):
        with pytest.raises(ValueError, match="native-graph"):
            det.export_fused(str(tmp_path / "again.adas"), GEOMS[0])
    int8 = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=YOLO_HW,
                        compute_dtype="int8", model_path=paths["yolo"], device="cpu")
    with pytest.raises(ValueError, match="native-graph"):
        int8.calibrate_int8(_frames(GEOMS[0], 1))
