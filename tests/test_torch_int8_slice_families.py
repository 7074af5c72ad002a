"""The port's calibrated int8 serving slice with the object nets YOLOv9
GELAN-C and EfficientDet-D0, against the JAX package.

As ``test_torch_int8_slice.py``: two streams of I420-transported 180x320
frames, one tick, through the JAX ``MultiStreamADAS`` with int8 facades
calibrated on two BGR frames and through the port's, which load the JAX
facades' calibrated, packed trees (scales, s8 kernels and all); UFLDv2 on
the reduced CULane spec of ``test_torch_slice``, int8 on both sides; the
JAX stems run their XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``).  YOLOv9c
at 96x96, its class predictors spread (kernels x10, biases -2: the
top scores of a frame reach ~0.6) and ``box_score`` 0.5; EfficientDet-D0 at 128x128 on the unscaled
random trunk (``test_torch_effdet_int8.py`` says why), its class header
spread as ``test_torch_effdet_slice``'s (kernel x5, bias -2: the top scores
of a frame reach ~0.5) and ``box_score`` 0.4.

Bounds, per stream and tick, those of ``test_torch_int8_slice.py`` (an
s8 value that moves by one LSB moves what follows): detection counts
within 20% (+2); at least half of the port's detections have a JAX
detection with the same label at IoU > 0.5 and a score within 0.05; the
number of detected lanes within 1; and detections in every run.
"""
import numpy as np
import pytest

from adas_tpu.models import efficientdet as jax_effdet
from adas_tpu.models import yolo as jax_yolo
from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.perception.efficientdet_detector import EfficientdetDetector as JaxEffdet
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from test_torch_efficientdet import random_tree
from test_torch_int8_slice import _matched
from test_torch_models import SPEC_ARGS, save_npz
from test_torch_slice import CULANE, FRAME_HW, _dets, _ticks, npz_paths
from test_torch_yolo_families import flax_weights

__all__ = ["npz_paths"]  # the lane weights' fixture of test_torch_slice
HW = (128, 128)
V9_HW = (96, 96)


def _object_npz(kind, tmp):
    """The object net's weights: YOLOv9c or EfficientDet-D0, scores spread
    (module docstring)."""
    import jax.numpy as jnp

    if kind == "v9":
        flat = flax_weights(jax_yolo.build_yolo(jax_yolo.YoloSpec("v9", "c", 80, V9_HW)),
                            (1, *V9_HW, 3), seed=12)
        for k in flat:
            if "::cls" in k and k.endswith("_2::kernel"):
                flat[k] *= 10.0
            elif "::cls" in k and k.endswith("_2::bias"):
                flat[k][:] = -2.0
    else:
        net = jax_effdet.EfficientDet(jax_effdet.EfficientDetSpec(compound=0, num_classes=80))
        flat = random_tree(net, [jnp.zeros((1, HW[0], HW[0], 3))], seed=13)
        flat["params::classifier::header::pw::kernel"] *= 5.0
        flat["params::classifier::header::pw::bias"][:] = -2.0
    path = str(tmp / f"{kind}.npz")
    save_npz(path, unflatten_variables(flat))
    return path


def _facades(kind, path, tmp=None):
    """(JAX facade, port facade factory) of the object side."""
    if kind == "v9":
        args = dict(scale="c", input_size=V9_HW, box_score=0.5, compute_dtype="int8")
        return (JaxYolo(model_path=path, model_type=ObjectModelType.YOLOV9, **args),
                lambda p: YoloDetector(model_path=p, model_type=PortObjectModelType.YOLOV9,
                                       device="cpu", **args))
    args = dict(compound=0, input_size=HW[0], box_score=0.4, compute_dtype="int8")
    return (JaxEffdet(model_path=path, **args),
            lambda p: EfficientdetDetector(model_path=p, device="cpu", **args))


@pytest.mark.parametrize("kind", ["v9", "effdet"])
def test_int8_slice_matches_jax(kind, npz_paths, tmp_path, monkeypatch):
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    monkeypatch.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        port_ufld.UFLDv2Spec(**SPEC_ARGS))
    frames = list(_ticks(1, seed=5)[0])
    jobj, make_obj = _facades(kind, _object_npz(kind, tmp_path))
    jlane = JaxLane(model_path=npz_paths["lane"], model_type=CULANE, dtype="int8")
    paths = {}
    for name, facade in (("obj", jobj), ("lane", jlane)):
        facade.calibrate_int8(frames)
        paths[name] = str(tmp_path / f"{name}_packed.npz")  # not *_int8.npz: the weight-only int8 store
        save_npz(paths[name], facade.variables)
    obj = make_obj(paths["obj"])
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype="int8", device="cpu")
    jms = JaxMultiStream(jobj, jlane, 2, frame_hw=FRAME_HW, transport="i420")
    ms = MultiStreamADAS(obj, lane, 2, frame_hw=FRAME_HW, transport="i420")
    n_dets = 0
    for tick in _ticks(1):
        for want, got in zip(jms.process_batch(tick), ms.process_batch(tick)):
            wl, wb, ws = _dets(want)
            gl, gb, gs = _dets(got)
            assert abs(len(gl) - len(wl)) <= 0.2 * len(wl) + 2
            assert np.all(np.isfinite(gb))
            assert sum(_matched(b, lab, sc, wb, wl, ws) for lab, b, sc in zip(gl, gb, gs)) \
                >= 0.5 * len(gl)
            assert abs(sum(got["lanes_status"]) - sum(want["lanes_status"])) <= 1
            n_dets += len(gl)
    ms.close()
    assert n_dets > 0
