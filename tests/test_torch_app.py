"""The port's per-frame pipeline (``pipeline/app.ADASPipeline``) against the
JAX package's, on the CPU.

Three seeded 360x640 frames go through both ``process_frame(draw=False)``
on the weights of ``test_torch_frame.py`` (YOLOv8n-320 with spread class
scores, UFLDv2-TuSimple), on the fused route (the default) and the
unfused one (object -> tracker -> lane).  After every frame the tracker's
ids (tracked and lost), the lane status and the offset, curvature and
collision signals must be identical, and so must the measured distances,
with one exception the two frameworks cannot avoid: the distance code
truncates each box to integers (``RectInfo.tolist``), and the boxes agree
to about 1e-4 of the frame (``test_torch_frame.py``), so an edge within
that of an integer can truncate to the neighbouring one (one edge in
these three frames).  A distance point whose integer box differs must trace back to
such an edge, and then its x and y are within one pixel.  Both packages
number tracks from one counter per process, so each run resets both
first.

Then the same with the HUD drawn (``draw=True``, the JAX default) on both
routes, frame against frame.  Also: the observability counters have the
JAX keys, and the facades take their options as the JAX ones do.
"""
import logging
import random

import numpy as np
import pytest

from adas_tpu.pipeline.app import ADASPipeline as JaxPipeline
from adas_tpu.tracking.base_track import BaseTrack as JaxBaseTrack
from adas_tpu.utils.logger import Logger as JaxLogger
from adas_tpu.utils.profiling import FPSCounter as JaxFPS
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector
from adas_tpu_torch.pipeline.app import ADASPipeline
from adas_tpu_torch.tracking.base_track import BaseTrack
from adas_tpu_torch.utils.logger import Logger
from adas_tpu_torch.utils.profiling import FPSCounter, StageTimers, annotate, device_trace
from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType
from test_torch_frame import BOX_SCORE, FRAME_HW, YOLO_HW, frame_weights, frames
from test_torch_slice import signal

__all__ = ["frame_weights"]  # the weight files, shared with test_torch_frame

QUIET = logging.WARNING


def pipelines(weights, use_fused, frame_hw=FRAME_HW, build=("jax", "port")):
    """The JAX and the port's pipelines on the same weights (None for a
    package not in ``build``)."""
    def configs(lane_type, object_type):
        return dict(
            frame_size=frame_hw[::-1],
            lane_config={"model_path": weights["tusimple"], "model_type": lane_type},
            object_config={"model_path": weights["yolo"], "model_type": object_type,
                           "scale": "n", "input_size": YOLO_HW, "box_score": BOX_SCORE},
            use_fused=use_fused,
        )

    jax_pipe = JaxPipeline(
        logger=JaxLogger(None, QUIET, QUIET),
        **configs(JaxLaneModelType.UFLDV2_TUSIMPLE, JaxObjectModelType.YOLOV8),
    ) if "jax" in build else None
    pipe = ADASPipeline(
        logger=Logger(None, QUIET, QUIET), device="cpu",
        **configs(LaneModelType.UFLDV2_TUSIMPLE, ObjectModelType.YOLOV8),
    ) if "port" in build else None
    return jax_pipe, pipe


def state(pipe):
    """What one frame leaves behind: track ids (tracked, lost), lane status,
    the signals."""
    tracker, msg = pipe.objectTracker, pipe.analyzeMsg
    return {
        "tracked": [t.track_id for t in tracker.tracked_stracks],
        "lost": [t.track_id for t in tracker.lost_stracks],
        "lanes": list(pipe.laneDetector.lane_info.lanes_status),
        "offset_msg": signal(msg.offset_msg),
        "curvature_msg": signal(msg.curvature_msg),
        "collision_msg": signal(msg.collision_msg),
    }


def measured(pipe):
    """(float box, integer box, distance point) of every object the
    distance code measured, in its order (``updateDistance``'s filter)."""
    dist = pipe.distanceDetector
    objs = [o for o in pipe.objectDetector.object_info
            if o.label in dist.object_list and o.tolist()[3] <= 650 and o.tolist()[3] > o.tolist()[1]]
    assert len(objs) == len(dist.distance_points)
    return [(np.array(o.tolist(dtype=float)), o.tolist(), list(p))
            for o, p in zip(objs, dist.distance_points)]


def assert_same_distances(want, got):
    """Distance points equal, but where a box edge truncated to another
    integer: then that edge lies within 1e-3 of an integer on one side and
    the point's x and y are within one pixel."""
    assert len(got) == len(want)
    for (wf, wi, wp), (gf, gi, gp) in zip(want, got):
        if gi == wi:
            assert gp == wp
            continue
        flipped = np.array(gi) != np.array(wi)
        near = np.minimum(np.abs(wf - np.round(wf)), np.abs(gf - np.round(gf)))
        assert np.all(near[flipped] < 1e-3), (wf, gf)
        assert abs(gp[0] - wp[0]) <= 1 and abs(gp[1] - wp[1]) <= 1


@pytest.mark.parametrize("use_fused", [True, False])
def test_process_frame_matches_jax(frame_weights, use_fused, monkeypatch):
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    jax_pipe, pipe = pipelines(frame_weights, use_fused)
    assert (pipe.fused is not None) == use_fused
    JaxBaseTrack.reset_counter()
    BaseTrack.reset_counter()
    n_tracked, n_dist = 0, 0
    for f in frames(3, seed=11):
        want_out = jax_pipe.process_frame(f, draw=False)
        got_out = pipe.process_frame(f, draw=False)
        np.testing.assert_array_equal(got_out, f)
        np.testing.assert_array_equal(want_out, f)
        assert state(pipe) == state(jax_pipe)
        assert_same_distances(measured(jax_pipe), measured(pipe))
        n_tracked += len(pipe.objectTracker.tracked_stracks)
        n_dist += len(pipe.distanceDetector.distance_points)
    assert n_tracked > 0 and n_dist > 0  # the frames track and measure something
    assert set(pipe.timers.summary()) == set(jax_pipe.timers.summary())
    assert pipe.object_infer_time >= 0 and pipe.lane_infer_time >= 0


class _FixedClock:
    """``time`` for the app and panel modules: a clock that never moves, so
    that both packages print the same inference times and FPS."""

    @staticmethod
    def time():
        return 1000.0


def _fix_clocks(monkeypatch):
    import adas_tpu.pipeline.app as jax_app
    import adas_tpu.pipeline.panel as jax_panel
    import adas_tpu_torch.pipeline.app as app
    import adas_tpu_torch.pipeline.panel as panel

    for mod in (jax_app, jax_panel, app, panel):
        monkeypatch.setattr(mod, "time", _FixedClock)


def drawing_pipelines(weights, use_fused, frame_hw=FRAME_HW):
    """The JAX and the port's pipelines on the same weights for
    ``frame_hw`` frames, each built after seeding ``random`` alike (the
    facades draw their class colours from it)."""
    random.seed(5)
    jax_pipe, _ = pipelines(weights, use_fused, frame_hw, build=("jax",))
    random.seed(5)
    _, pipe = pipelines(weights, use_fused, frame_hw, build=("port",))
    assert pipe.objectDetector.colors_dict == jax_pipe.objectDetector.colors_dict
    return jax_pipe, pipe


#: the least share of identical pixels per drawn frame (measured: see
#: test_draw_matches_jax)
DRAW_EQUAL = 0.99


@pytest.mark.parametrize("use_fused", [True, False])
def test_draw_matches_jax(frame_weights, use_fused, monkeypatch):
    """``process_frame(draw=True)`` (the HUD) against the JAX package's on
    the three seeded 360x640 frames and one 720x1280 frame: at least 99%
    of the pixels identical per frame (measured on both routes: 99.53%,
    99.96%, 99.93% and 99.82%), the signals,
    ids and lane status identical, and every signal equal to a
    ``draw=False`` run of the port over the same frames.  The pixels that
    differ trace to the two known gaps: a box edge truncated to the
    neighbouring integer (module docstring; here two ``person`` boxes at
    x = 151/152 and 423/424 on the first frame move their label, corner
    box and distance label by a pixel), and the bird-view inset, whose
    warp is within one level of JAX's."""
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    _fix_clocks(monkeypatch)
    shares = []
    for hw, fs in ((FRAME_HW, frames(3, seed=11)), ((720, 1280), frames(1, seed=12, hw=(720, 1280)))):
        jax_pipe, pipe = drawing_pipelines(frame_weights, use_fused, hw)
        _, plain = pipelines(frame_weights, use_fused, hw, build=("port",))
        JaxBaseTrack.reset_counter()
        BaseTrack.reset_counter()
        drawn_states = []
        for f in fs:
            want = jax_pipe.process_frame(f)
            got = pipe.process_frame(f)
            assert got.shape == want.shape and got.dtype == np.uint8
            assert not np.array_equal(got, f)  # the HUD drew
            shares.append(float(np.mean(np.all(got == want, axis=-1))))
            assert state(pipe) == state(jax_pipe)
            drawn_states.append(state(pipe))
        BaseTrack.reset_counter()
        for f, drawn in zip(fs, drawn_states):
            plain.process_frame(f, draw=False)
            assert state(plain) == drawn
    print("identical pixels per frame:", [round(v, 5) for v in shares])
    assert min(shares) >= DRAW_EQUAL, shares


def test_draw_raises(tmp_path):
    """Drawing to a window (``display=True``, the JAX ``cv2.imshow``) raises
    in ``run_video``, ``run_synthetic``'s CLI and ``main``: the card's host
    has no window system.  Nothing is built or written first."""
    from adas_tpu_torch.pipeline.app import main, run_video

    out = tmp_path / "out.y4m"
    with pytest.raises(NotImplementedError, match="window"):
        run_video(str(tmp_path / "in.y4m"), str(out), display=True, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        main(["--synthetic", "--display", "-o", str(out), "--device", "cpu"])
    assert not out.exists()


def test_stage_timers_and_fps_have_the_jax_keys():
    timers = StageTimers()
    for _ in range(3):
        with timers.stage("a"):
            pass
    summary = timers.summary()
    assert set(summary["a"]) == {"n", "mean_ms", "p50_ms", "p95_ms"} and summary["a"]["n"] == 3
    assert timers.last("a") >= 0 and timers.last("b") == 0.0
    fps, jfps = FPSCounter(window=3), JaxFPS(window=3)
    assert [fps.tick() > 0 for _ in range(3)] == [jfps.tick() > 0 for _ in range(3)]
    assert set(vars(fps)) == set(vars(jfps))


def test_device_trace_writes(tmp_path):
    import torch

    with device_trace(None):  # hook left in place, disabled
        pass
    with device_trace(str(tmp_path)):
        with annotate("double"):
            (torch.ones(8) * 2).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_logger_has_the_jax_methods():
    names = {n for n in vars(JaxLogger) if not n.startswith("_")}
    assert names == {n for n in vars(Logger) if not n.startswith("_")}


def test_facade_options_follow_set_defaults():
    """``set_defaults`` / ``check_defaults`` / ``get_defaults`` as the JAX
    facades have them; an option the port does not take raises."""
    assert YoloDetector.check_defaults() is YOLO_OPTIONS
    assert YoloDetector.get_defaults("box_score") == 0.4
    assert YoloDetector.get_defaults("nope") == "Unrecognized attribute name 'nope'"
    try:
        YoloDetector.set_defaults({**YOLO_OPTIONS, "box_score": 0.3, "input_size": (64, 64)})
        det = YoloDetector(device="cpu")
        assert det.box_score == 0.3 and det.spec.input_size == (64, 64)
        assert YoloDetector(device="cpu", box_score=0.5).box_score == 0.5
    finally:
        YoloDetector.set_defaults(YOLO_OPTIONS)
    with pytest.raises(TypeError, match="engine"):
        YoloDetector(device="cpu", input_size=(64, 64), engine="graph")
    # JAX's onnx_mode is an option (it acts on an .onnx model_path only)
    assert YoloDetector(device="cpu", input_size=(64, 64), onnx_mode="graph").onnx_mode == "graph"
    with pytest.raises(ValueError, match="YOLOv10"):
        YoloDetector(device="cpu", input_size=(64, 64), nms_free=True)
    with pytest.raises(TypeError, match="scale"):
        EfficientdetDetector(device="cpu", input_size=128, scale="n")
    assert EfficientdetDetector.get_defaults("compute_dtype") is None  # int8 is an option too
    assert UltrafastLaneDetectorV2.get_defaults("model_type") is LaneModelType.UFLDV2_CULANE


def test_ufld_v1_is_not_ported():
    """An ``ADASPipeline`` with a UFLD v1 lane model runs unfused, as in
    JAX (v1 has no fused route).  Its dynamic-scale int8, which once
    raised here, is ported now: the facade packs an int8 net (held to JAX
    in ``test_torch_multistream_int8.py``)."""
    from adas_tpu_torch.models.quant import QConv2d, QLinear

    pipe = ADASPipeline(lane_config={"model_type": LaneModelType.UFLD_TUSIMPLE},
                        object_config={"input_size": (64, 64)}, device="cpu")
    assert isinstance(pipe.laneDetector, UltrafastLaneDetector) and pipe.fused is None
    v1 = UltrafastLaneDetector(model_type=LaneModelType.UFLD_CULANE, compute_dtype="int8",
                               device="cpu")
    assert all(m.wq is not None for m in v1.net.modules() if isinstance(m, (QConv2d, QLinear)))
    assert any(isinstance(m, QLinear) for m in v1.net.modules())
