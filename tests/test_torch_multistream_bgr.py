"""The port's ``MultiStreamADAS`` against the JAX package's: its signature
and defaults, the bgr transport (JAX's default) and ``host_downscale``.

Two streams, two ticks, on the weights and nets of ``test_torch_slice``
(YOLOv8n at 160x160, UFLDv2 on the reduced CULane spec, random weights
from a numpy seed, one ``params_io`` ``.npz`` per net loaded by both
packages).  The JAX stems run their XLA chain
(``ADAS_DISABLE_PALLAS_STEM=1``), the port's their plain CPU version.

Bounds, per stream and tick, f32 on bgr, and f32 on I420 with
``host_downscale`` (the frames resized on the host, by cv2 in JAX and by
``render/draw.resize_linear`` in the port, equal to the bit when
downscaling): ``test_slice_f32_matches_jax``'s: labels and track counts
identical, boxes within 1e-2 px, scores within 1e-4, lane points and
signals identical.  Calibrated int8 on bgr is held beside the I420 int8
slice, on its one calibration (``test_torch_int8_slice.py``
``test_bgr_int8_close_to_jax``).
"""
import inspect

import numpy as np
import pytest

from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from test_torch_models import SPEC_ARGS
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, _dets, _ticks, npz_paths, signal, weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests


#: named on both sides: ``tests/test_yolo.py`` sets JAX's ``YoloDetector``
#: class defaults to ``max_det`` 20 for the rest of its test process
MAX_DET = 100


def _port_pair(paths):
    yolo = YoloDetector(model_path=paths["yolo"], model_type=PortObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, max_det=MAX_DET,
                        device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], device="cpu")
    return yolo, lane


def _jax_pair(paths):
    jyolo = JaxYolo(model_path=paths["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
                    input_size=YOLO_HW, box_score=0.25, max_det=MAX_DET)
    return jyolo, JaxLane(model_path=paths["lane"], model_type=CULANE)


def test_signature_matches_jax():
    """Names, order, kinds and defaults of the constructor's parameters."""
    want = inspect.signature(JaxMultiStream.__init__).parameters
    got = inspect.signature(MultiStreamADAS.__init__).parameters
    assert list(got) == list(want) == ["self", "yolo", "lane", "n_streams", "frame_hw", "mesh",
                                       "host_downscale", "transport", "step_artifact"]
    for name in want:
        assert got[name].kind == want[name].kind
        assert got[name].default == want[name].default, name
    assert got["transport"].default == "bgr"
    assert inspect.signature(MultiStreamADAS.serve_pipelined).parameters["upload_workers"] \
        .default == inspect.signature(JaxMultiStream.serve_pipelined) \
        .parameters["upload_workers"].default == 1


def test_defaults_serve_bgr(monkeypatch):
    """``MultiStreamADAS(yolo, lane, n, hw)`` uploads the BGR frames as
    they are; a mesh and a step artifact that does not exist raise."""
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        port_ufld.UFLDv2Spec(**SPEC_ARGS))
    yolo = YoloDetector(model_type=PortObjectModelType.YOLOV8, scale="n", input_size=(64, 64),
                        device="cpu")
    lane = UltrafastLaneDetectorV2(device="cpu")
    ms = MultiStreamADAS(yolo, lane, 2, FRAME_HW)
    frames = _ticks(1)[0]
    assert ms.transport == "bgr" and ms.dev_hw == FRAME_HW
    assert ms._host_prep(frames) is frames
    assert tuple(ms._prep_upload(frames).shape) == (2, *FRAME_HW, 3)
    assert len(ms.process_batch(frames)) == 2
    ms.close()
    with pytest.raises(ValueError, match="mesh"):
        MultiStreamADAS(yolo, lane, 2, FRAME_HW, mesh=object())
    with pytest.raises(FileNotFoundError):
        MultiStreamADAS(yolo, lane, 2, FRAME_HW, step_artifact="step.adas")
    with pytest.raises(ValueError, match="transport"):
        MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport="nv12")


def _assert_f32_ticks_match(jms, ms):
    n_dets = 0
    for frames in _ticks(2):
        for want, got in zip(jms.process_batch(frames), ms.process_batch(frames)):
            wl, wb, ws = _dets(want)
            gl, gb, gs = _dets(got)
            assert gl == wl
            np.testing.assert_allclose(gb, wb, atol=1e-2)
            np.testing.assert_allclose(gs, ws, atol=1e-4)
            n_dets += len(gl)
            assert got["tracks"] == want["tracks"]
            assert got["lanes_status"] == want["lanes_status"]
            for gp, wp in zip(got["lanes_points"], want["lanes_points"]):
                assert list(gp) == list(wp)
            for key in ("collision", "offset", "curvature", "area_status"):
                assert signal(got[key]) == signal(want[key])
    ms.close()
    assert n_dets > 0


def test_bgr_f32_matches_jax(weights):
    jyolo, jlane = _jax_pair(weights)
    yolo, lane = _port_pair(weights)
    _assert_f32_ticks_match(JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW),
                            MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW))


def test_host_downscale_matches_jax(weights):
    """I420 of frames downscaled on the host to (100, 176), as the JAX bench
    runs its ticks; the detections come back in the frame's pixels."""
    jyolo, jlane = _jax_pair(weights)
    yolo, lane = _port_pair(weights)
    kw = dict(frame_hw=FRAME_HW, host_downscale=(100, 176), transport="i420")
    jms, ms = JaxMultiStream(jyolo, jlane, 2, **kw), MultiStreamADAS(yolo, lane, 2, **kw)
    frames = _ticks(1)[0]
    np.testing.assert_array_equal(ms._host_prep(frames), jms._host_prep(frames))
    assert ms.dev_hw == jms.dev_hw == (100, 176)
    _assert_f32_ticks_match(jms, ms)
