"""The port's transport-ladder guardrail
(``adas_tpu_torch/pipeline/transport_parity.py``) against the JAX
package's (``adas_tpu/pipeline/transport_parity.py``), whose round trip
and downscale are cv2's.

``transport_view`` is held to JAX's to the bit (the port's
``bgr_to_i420`` / ``i420_to_bgr`` are cv2's to the bit, and
``resize_linear`` is cv2's ``INTER_LINEAR`` when downscaling); the
matching math on box and lane sets and ``measure_transport_drift`` over
the same facades give JAX's dict exactly (the facade run: the YOLOv8n and
reduced-CULane UFLDv2 of ``test_torch_slice``, the port's on the CPU, on
two seeded 180x320 frames at the 90x160 rung).
"""
import numpy as np
import pytest

from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline import transport_parity as jtp
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline import transport_parity as tp
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, npz_paths, weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests


def test_constants_match_jax():
    assert (tp.MATCH_IOU, tp.LANE_Y_TOL) == (jtp.MATCH_IOU, jtp.LANE_Y_TOL)


@pytest.mark.parametrize("rung", [(360, 640), (180, 320), (90, 160), (720, 1280)])
def test_transport_view_is_jax_to_the_bit(rung):
    frame = np.random.default_rng(rung[0]).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    got, want = tp.transport_view(frame, rung), jtp.transport_view(frame, rung)
    assert got.shape == want.shape == (*rung, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_roundtrip_of_a_smooth_frame_is_jax_to_the_bit():
    """A frame with gradients (not noise): the chroma of a 2x2 block."""
    y, x = np.mgrid[0:360, 0:640]
    frame = np.stack([x % 256, y % 256, (x + y) // 4 % 256], axis=-1).astype(np.uint8)
    np.testing.assert_array_equal(tp._i420_roundtrip(frame), jtp._i420_roundtrip(frame))


def test_matching_math_matches_jax():
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 100, (7, 4)).reshape(7, 2, 2), axis=1).reshape(7, 4)
    b = np.concatenate([a[:4] + rng.normal(0, 3, (4, 4)), rng.uniform(0, 100, (3, 4))])
    b = np.sort(b.reshape(-1, 2, 2), axis=1).reshape(-1, 4).astype(np.float32)
    a = a.astype(np.float32)
    np.testing.assert_array_equal(tp._iou_matrix(a, b), jtp._iou_matrix(a, b))
    assert tp._match_boxes(a, b) == jtp._match_boxes(a, b)
    assert tp._iou_matrix(a[:0], b).shape == (0, len(b))


def test_measure_transport_drift_matches_jax(weights):
    jyolo = JaxYolo(model_path=weights["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
                    input_size=YOLO_HW, box_score=0.25)
    jlane = JaxLane(model_path=weights["lane"], model_type=CULANE)
    yolo = YoloDetector(model_path=weights["yolo"], model_type=PortObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=weights["lane"], device="cpu")
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(2)]
    got = tp.measure_transport_drift(yolo, lane, frames, (90, 160))
    want = jtp.measure_transport_drift(jyolo, jlane, frames, (90, 160))
    assert got == want
    assert got["native_dets"] > 0 and got["rung"] == [90, 160]
    assert tp.measure_transport_drift(yolo, None, frames, (90, 160))["lane_x_err_px"] == 0.0
