"""The port's calibrated int8 serving slice against the JAX package.

Two streams of I420-transported frames, two ticks, through the JAX
``MultiStreamADAS`` with ``compute_dtype="int8"`` / ``dtype="int8"``
facades and through the port's with ``compute_dtype="int8"``, on the same
weights and the same calibration: the JAX facades calibrate on two BGR
frames, their calibrated and packed variable trees are saved as
``params_io`` archives, and the port's facades load those (scales, s8
kernels and all).  YOLOv8n at 160x160 and UFLDv2 on the reduced CULane
spec of ``test_torch_slice``; the JAX stems run their XLA chain
(``ADAS_DISABLE_PALLAS_STEM=1``), the port's their plain CPU version.

The stems round in bf16 at other places (the JAX chain rounds the conv
output before its f32 epilogue, the port's kernel does not), an s8 value
that moves by one LSB moves what follows, and these random weights (class
logits scaled 10x) amplify it: the port's class scores are 5.6% (relative
L2) from JAX's, while each side is 6.1-6.5% from the f32 net.  So the
bf16 slice test's bounds (``test_torch_slice.py:151-172``) hold for the
counts but not for the matching, and a lane whose valid-anchor count sits
at the detection threshold (more than half the row anchors) flips
between 37 points and none; NMS keeps another neighbour of a box, and
boxes near the 0.25 score threshold come and go.  Stated bounds, per
stream and tick: detection counts within 20% (+2) (14 against 12 at the
most in this run); at least half of the port's detections have a JAX
detection with the same label at IoU > 0.5 and a score within 0.05 (8 of
14 at the least); the decoded anchors of the packed device output agree
on validity for at least 95% of the row and column anchors (96.9% at the
least); the number of detected lanes within 1.  The same bounds hold the
calibrated nets on both packages' default transport, bgr (the frames
uploaded as they are, no I420 encode).  Also: the port's own calibrator
on the same frames gives a slice that detects.
"""
import numpy as np
import pytest

from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.ops.packing import unpack as jax_unpack
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.ops.packing import unpack
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from test_torch_models import SPEC_ARGS, save_npz
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, _dets, _ticks, npz_paths

__all__ = ["npz_paths"]  # the weight-file fixture, shared with the bf16 slice test


def _matched(box, label, score, wb, wl, ws) -> bool:
    """Whether a JAX detection has ``label``, IoU > 0.5 with ``box`` and a
    score within 0.05."""
    lt = np.maximum(box[:2], wb[:, :2])
    rb = np.minimum(box[2:], wb[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = (wb[:, 2] - wb[:, 0]) * (wb[:, 3] - wb[:, 1])
    iou = inter / ((box[2] - box[0]) * (box[3] - box[1]) + area - inter)
    same = np.array([lab == label for lab in wl], bool)
    return bool(np.any((iou > 0.5) & same & (np.abs(ws - score) < 0.05)))


@pytest.fixture(scope="module")
def calibrated(npz_paths, tmp_path_factory):
    """JAX int8 facades calibrated on two frames, and their calibrated,
    packed trees saved for the port (the reduced CULane spec on both sides
    and the JAX stems' XLA chain for the module's tests)."""
    tmp = tmp_path_factory.mktemp("int8_slice")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
        mp.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(
            port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
            port_ufld.UFLDv2Spec(**SPEC_ARGS),
        )
        frames = list(_ticks(1, seed=5)[0])
        jyolo = JaxYolo(
            model_path=npz_paths["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
            input_size=YOLO_HW, box_score=0.25, compute_dtype="int8",
        )
        jlane = JaxLane(model_path=npz_paths["lane"], model_type=CULANE, dtype="int8")
        paths = {}
        for name, facade in (("yolo", jyolo), ("lane", jlane)):
            facade.calibrate_int8(frames)
            paths[name] = str(tmp / f"{name}_packed.npz")  # not *_int8.npz: the weight-only int8 store
            save_npz(paths[name], facade.variables)
        yield jyolo, jlane, paths, frames


def _port_int8_pair(paths):
    yolo = YoloDetector(model_path=paths["yolo"], model_type=PortObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, compute_dtype="int8",
                        device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype="int8", device="cpu")
    return yolo, lane


def _assert_int8_ticks_close(jms, ms):
    """Two ticks of both packages' ``MultiStreamADAS`` held to the module's
    stated bounds."""
    n_dets = 0
    for frames in _ticks(2):
        jhandle, handle = jms.submit(frames), ms.submit(frames)
        jflat, flat = np.asarray(jhandle), handle.numpy()
        for i, (want, got) in enumerate(zip(jms.fetch(jhandle, frames),
                                            ms.fetch(handle, frames))):
            wl, wb, ws = _dets(want)
            gl, gb, gs = _dets(got)
            assert abs(len(gl) - len(wl)) <= 0.2 * len(wl) + 2
            assert np.all(np.isfinite(gb)) and np.all((gs > 0.25) & (gs <= 1))
            assert sum(_matched(b, lab, sc, wb, wl, ws) for lab, b, sc in zip(gl, gb, gs)) \
                >= 0.5 * len(gl)
            assert abs(sum(got["lanes_status"]) - sum(want["lanes_status"])) <= 1
            _, jlanes = jax_unpack(jflat[i], jms._spec_holder["spec"])
            _, lanes = unpack(flat[i], ms._pack_spec)
            for k in ("row_valid", "col_valid"):
                assert (np.asarray(jlanes[k]) == np.asarray(lanes[k])).mean() >= 0.95
            n_dets += len(gl)
    ms.close()
    assert n_dets > 0


def test_slice_int8_close_to_jax(calibrated):
    jyolo, jlane, paths, _ = calibrated
    yolo, lane = _port_int8_pair(paths)
    _assert_int8_ticks_close(JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW, transport="i420"),
                             MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport="i420"))


def test_bgr_int8_close_to_jax(calibrated):
    """The same calibrated nets on both packages' default transport, bgr
    (the frames uploaded as they are), at the same bounds."""
    jyolo, jlane, paths, _ = calibrated
    yolo, lane = _port_int8_pair(paths)
    _assert_int8_ticks_close(JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW),
                             MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW))


def test_slice_int8_with_port_calibration(calibrated, npz_paths):
    """The port's own packer and calibrator (f32 weights in, BGR frames)
    serve a slice that detects, with every int8 buffer set."""
    _, _, _, frames = calibrated
    yolo, lane = _port_int8_pair(npz_paths)
    for facade in (yolo, lane):
        facade.calibrate_int8(frames)
        assert all(m.xmax is not None for m in facade.net.modules() if hasattr(m, "xmax"))
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport="i420")
    out = ms.process_batch(_ticks(1)[0])
    ms.close()
    assert sum(len(r["objects"]) for r in out) > 0
    assert all(len(r["lanes_status"]) == 4 for r in out)
