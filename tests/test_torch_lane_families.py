"""UFLD v1 (TuSimple and CULane), UFLDv2 on CurveLanes, and
``ADASPipeline.process_frame`` with the newly ported model pairs, against
the JAX package on the CPU.

The v1 nets on a 64x160 input with a 64-wide MLP (the full griding and
row counts) in f32, through one flax variable tree made from a numpy
seed: logits at rtol 1e-3 with an atol of 1e-3 of their largest
magnitude (``test_torch_models.py``); ``ufld_v1_decode`` at atol 1e-5,
rtol 1e-6 (grid locations up to 200: the f32 expectation's last bits)
and ``ufld_v1_preprocess`` at atol 1e-5.  The CurveLanes spec row equals JAX's.

The pipelines, at ``test_torch_app.py``'s yardstick (three seeded 360x640
frames, ``process_frame(draw=False)``; tracker ids, lane status and the
signals identical after every frame; distances identical but where a box
edge truncates to the neighbouring integer):

* YOLOv5n-320 + UFLD v1-CULane (288x800, the MLP cut to 128 wide), the
  unfused route, as JAX runs a v1 pair;
* YOLOv10n-320 (one-to-many head + NMS) + UFLDv2 with CurveLanes'
  geometry (800 rows: CurveLanes' row anchors; the width cut to 160 and
  the MLP to 64 wide), on both routes.  JAX's ``UltrafastLaneDetectorV2``
  refuses ``UFLDV2_CURVELANES`` (``lane_detector.py:125-128``), so its
  pipeline holds the same spec under the CULane key; the port's is built
  as ``UFLDV2_CURVELANES``.

The YOLO weights get the score spread of ``test_torch_frame.py``: a kernel
gain on the trunk (1.37 for v5, 1.3 for v10: deep random nets forget
their input below it and saturate above it) and a 10x, -5-biased class
(v5: objectness and classes) predictor, so that candidates pass
``box_score`` and their order is not f32 noise.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import ufld as jufld
from adas_tpu.models import yolo as jyolo
from adas_tpu.ops.preprocess import ufld_v1_preprocess as jax_v1_preprocess
from adas_tpu.ops.ufld_decode import ufld_v1_decode as jax_v1_decode
from adas_tpu.pipeline.app import ADASPipeline as JaxPipeline
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.tracking.base_track import BaseTrack as JaxBaseTrack
from adas_tpu.utils.logger import Logger as JaxLogger
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.models import ufld
from adas_tpu_torch.ops.preprocess import ufld_v1_preprocess
from adas_tpu_torch.ops.ufld_decode import ufld_v1_decode
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from adas_tpu_torch.pipeline.app import ADASPipeline
from adas_tpu_torch.tracking.base_track import BaseTrack
from adas_tpu_torch.utils.logger import Logger
from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType
from adas_tpu_torch.weights import load_flax_variables
from test_torch_app import QUIET, assert_same_distances, measured, state
from test_torch_frame import BOX_SCORE, FRAME_HW, YOLO_HW, frames
from test_torch_yolo_families import flax_weights
from test_torch_models import save_npz

V1 = {"tusimple": (JaxLaneModelType.UFLD_TUSIMPLE, LaneModelType.UFLD_TUSIMPLE),
      "culane": (JaxLaneModelType.UFLD_CULANE, LaneModelType.UFLD_CULANE)}


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("name", ["tusimple", "culane"])
def test_ufld_v1_matches_jax(name):
    jspec = dataclasses.replace(jufld.UFLDV1_SPECS[V1[name][0]], input_height=64,
                                input_width=160, mlp_mid=64)
    spec = dataclasses.replace(ufld.UFLDV1_SPECS[V1[name][1]], input_height=64,
                               input_width=160, mlp_mid=64)
    jnet = jufld.UFLDv1Net(jspec)
    x = np.random.default_rng(0).standard_normal((2, 64, 160, 3)).astype(np.float32)
    flat = flax_weights(jnet, (1, 64, 160, 3), seed=1)
    want = np.asarray(jax.jit(jnet.apply)(
        jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat)), jnp.asarray(x)))
    net = ufld.UFLDv1Net(spec).eval()
    load_flax_variables(net, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, spec.griding_num + 1, spec.cls_num_per_lane, 4)
    _close(got, want)
    np.testing.assert_allclose(ufld_v1_decode(torch.from_numpy(got)).numpy(),
                               np.asarray(jax_v1_decode(jnp.asarray(got))), atol=1e-5, rtol=1e-6)


def test_ufld_v1_decode_matches_jax():
    """Random logits with the background cell winning a third of the
    (row, lane) slots."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 101, 56, 4)).astype(np.float32)
    logits[:, 100][rng.uniform(size=(2, 56, 4)) < 1 / 3] = 10.0
    got = ufld_v1_decode(torch.from_numpy(logits)).numpy()
    want = np.asarray(jax_v1_decode(jnp.asarray(logits)))
    assert got.shape == (2, 56, 4) and 0.2 < (want == 0).mean() < 0.5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_ufld_v1_preprocess_matches_jax():
    frame = np.random.default_rng(3).integers(0, 256, (2, 360, 640, 3), dtype=np.uint8)
    got = ufld_v1_preprocess(frame, 288, 800, device="cpu").numpy()
    want = np.asarray(jax_v1_preprocess(jnp.asarray(frame), 288, 800)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_curvelanes_spec_matches_jax():
    want = jufld.UFLDV2_SPECS[JaxLaneModelType.UFLDV2_CURVELANES]
    got = ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CURVELANES]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dims == want.dims and got.flat_features == 8 * 25 * 50
    np.testing.assert_array_equal(got.row_anchor, want.row_anchor)
    np.testing.assert_array_equal(got.col_anchor, want.col_anchor)


def _spread(flat, gain):
    """The YOLO score spread (module docstring): v8/v10's class predictors
    are ``cls*_2``; v5's ``head0``-``head2`` predict (x, y, w, h, obj,
    classes) per anchor, of which the objectness and the classes spread
    (a saturated w or h would make zero-height boxes, which the tracker
    cannot take)."""
    for k in flat:
        v5_head = re.search(r"::head\d::", k) is not None
        pred = k.endswith(("_2::kernel", "_2::bias")) or v5_head
        if k.endswith("kernel") and not pred:
            flat[k] *= gain
        elif pred and ("::cls" in k or v5_head):
            a = flat[k].reshape(*flat[k].shape[:-1], -1, 85)[..., 4:] if v5_head else flat[k]
            if k.endswith("kernel"):
                a *= 10.0
            else:
                a[...] = -5.0
    return flat


#: (object family, lane): the pairs of ``test_process_frame_matches_jax``
PAIRS = {
    "v5_v1": ("v5", 1.37, JaxObjectModelType.YOLOV5, ObjectModelType.YOLOV5),
    "v10_curvelanes": ("v10", 1.3, JaxObjectModelType.YOLOV10, ObjectModelType.YOLOV10),
}
V1_SPEC = dict(mlp_mid=128)
CURVE_SPEC = dict(input_width=160, num_cell_row=20, num_cell_col=10, mlp_mid=64)


@pytest.fixture(scope="module")
def pair_weights(tmp_path_factory):
    """One params_io .npz per net: YOLOv5n-320 and YOLOv10n-320 (spread),
    UFLD v1-CULane with a 128-wide MLP, UFLDv2 on the cut CurveLanes
    spec."""
    tmp = tmp_path_factory.mktemp("pair_weights")
    flats = {}
    for key, (family, gain, _, _) in PAIRS.items():
        net = jyolo.build_yolo(jyolo.YoloSpec(family, "n", 80, YOLO_HW))
        call = dict(method=net.both) if family == "v10" else {}
        flats[family] = _spread(flax_weights(net, (1, *YOLO_HW, 3), seed=21, **call), gain)
    v1 = dataclasses.replace(jufld.UFLDV1_SPECS[JaxLaneModelType.UFLD_CULANE], **V1_SPEC)
    flats["v1"] = flax_weights(jufld.UFLDv1Net(v1), (1, 288, 800, 3), seed=22)
    curve = dataclasses.replace(jufld.UFLDV2_SPECS[JaxLaneModelType.UFLDV2_CURVELANES],
                                **CURVE_SPEC)
    flats["curvelanes"] = flax_weights(jufld.UFLDv2Net(curve), (1, 800, 160, 3), seed=23)
    paths = {}
    for name, flat in flats.items():
        paths[name] = str(tmp / f"{name}.npz")
        save_npz(paths[name], unflatten_variables(flat))
    return paths


def _pipelines(weights, key, use_fused, monkeypatch):
    family, _, jax_type, port_type = PAIRS[key]
    if key == "v5_v1":
        jlane, lane = JaxLaneModelType.UFLD_CULANE, LaneModelType.UFLD_CULANE
        monkeypatch.setitem(jufld.UFLDV1_SPECS, jlane,
                            dataclasses.replace(jufld.UFLDV1_SPECS[jlane], **V1_SPEC))
        monkeypatch.setitem(ufld.UFLDV1_SPECS, lane,
                            dataclasses.replace(ufld.UFLDV1_SPECS[lane], **V1_SPEC))
        lane_path = weights["v1"]
    else:
        jlane, lane = JaxLaneModelType.UFLDV2_CULANE, LaneModelType.UFLDV2_CURVELANES
        monkeypatch.setitem(jufld.UFLDV2_SPECS, jlane, dataclasses.replace(
            jufld.UFLDV2_SPECS[JaxLaneModelType.UFLDV2_CURVELANES], **CURVE_SPEC))
        monkeypatch.setitem(ufld.UFLDV2_SPECS, lane,
                            dataclasses.replace(ufld.UFLDV2_SPECS[lane], **CURVE_SPEC))
        lane_path = weights["curvelanes"]
    obj = dict(model_path=weights[family], scale="n", input_size=YOLO_HW, box_score=BOX_SCORE)
    jax_pipe = JaxPipeline(
        frame_size=FRAME_HW[::-1], logger=JaxLogger(None, QUIET, QUIET), use_fused=use_fused,
        lane_config={"model_path": lane_path, "model_type": jlane},
        object_config={**obj, "model_type": jax_type},
    )
    pipe = ADASPipeline(
        frame_size=FRAME_HW[::-1], logger=Logger(None, QUIET, QUIET), use_fused=use_fused,
        lane_config={"model_path": lane_path, "model_type": lane},
        object_config={**obj, "model_type": port_type}, device="cpu",
    )
    return jax_pipe, pipe


@pytest.mark.parametrize("key,use_fused", [
    ("v5_v1", False), ("v10_curvelanes", True), ("v10_curvelanes", False),
])
def test_process_frame_matches_jax(pair_weights, key, use_fused, monkeypatch):
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    jax_pipe, pipe = _pipelines(pair_weights, key, use_fused, monkeypatch)
    assert (pipe.fused is not None) == use_fused == (jax_pipe.fused is not None)
    lane_cls = UltrafastLaneDetector if key == "v5_v1" else UltrafastLaneDetectorV2
    assert isinstance(pipe.laneDetector, lane_cls)
    JaxBaseTrack.reset_counter()
    BaseTrack.reset_counter()
    n_objects, n_tracked, lanes = 0, 0, 0
    for f in frames(3, seed=11):
        jax_pipe.process_frame(f, draw=False)
        pipe.process_frame(f, draw=False)
        assert state(pipe) == state(jax_pipe)
        assert_same_distances(measured(jax_pipe), measured(pipe))
        np.testing.assert_array_equal(
            np.array([p for pts in pipe.laneDetector.lane_info.lanes_points for p in pts]),
            np.array([p for pts in jax_pipe.laneDetector.lane_info.lanes_points for p in pts]))
        n_objects += len(pipe.objectDetector.object_info)
        n_tracked += len(pipe.objectTracker.tracked_stracks)
        lanes += sum(pipe.laneDetector.lane_info.lanes_status)
    # the frames detect, track and find lanes, and not at the max_det cap
    assert 0 < n_objects < 3 * 100 and n_tracked > 0 and lanes > 0, (n_objects, n_tracked, lanes)
