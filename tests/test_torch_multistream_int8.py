"""Uncalibrated int8 in the port against the JAX package: per-stream
dynamic scales, UFLD v1 int8, and ``MultiStreamADAS``'s compute probe and
``serve_pipelined(upload_workers=)``.

An int8 net with no calibrated scale quantizes each input at its dynamic
absmax scale.  JAX vmaps its multi-stream step over streams, so that scale
is each stream's own; the port takes it per batch element
(``models/quant.dynamic_scale``), and the int8 conv kernel's epilogue
reads a row of scales per image.  So each stream's output is independent
of the other streams' frames, to the bit.

The slice: two streams of I420 frames, two ticks, YOLOv8n at 160x160 and
UFLDv2 on the reduced CULane spec (``test_torch_slice``'s weights), both
``compute_dtype="int8"`` in JAX and uncalibrated; their packed trees (s8
kernels and weight scales, no activation scales) are saved and loaded by
the port's facades.  Bounds: ``test_torch_int8_slice``'s, per stream and
tick (counts within 20% + 2; at least half of the port's detections
matched by a JAX detection of the same label at IoU > 0.5 and a score
within 0.05; the anchors' validity equal on at least 95%; the detected
lanes within 1).

UFLD v1 int8 (JAX's ``dtype="int8"``: packed weights, dynamic scales, f32
input) on CULane's geometry cut to a 64x160 input and a 64-wide MLP, one
``DetectFrame`` of a 180x320 frame on each side: logits within 3e-2
relative L2 (the bound of the int8 nets with a stem, ``test_torch_int8_models``:
JAX's int8 stem is an XLA bf16 conv, the port's the stem kernel's plain
version); the decoded grid locations equal where both sides find the lane
point, found on the same 95% of (row, lane) slots, and within 1% of the
grid elsewhere; the lane status equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import ufld as jufld
from adas_tpu.models.layers import quantized
from adas_tpu.ops.packing import unpack as jax_unpack
from adas_tpu.ops.preprocess import ufld_v1_preprocess as jax_v1_preprocess
from adas_tpu.perception.lane_detector import UltrafastLaneDetector as JaxV1
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.quant import dynamic_scale
from adas_tpu_torch.ops.packing import unpack
from adas_tpu_torch.ops.preprocess import ufld_v1_preprocess
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.utils.types import LaneModelType
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from test_torch_int8_slice import _matched
from test_torch_models import SPEC_ARGS, save_npz
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, _dets, _ticks, npz_paths, weights
from test_torch_yolo_families import flax_weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests


@pytest.fixture(scope="module")
def packed(npz_paths, tmp_path_factory):
    """JAX's uncalibrated int8 facades and their packed trees, saved for
    the port (the reduced CULane spec on both sides and the JAX stems'
    XLA chain for the module's tests)."""
    from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
    from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec

    tmp = tmp_path_factory.mktemp("uncal_int8")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
        mp.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                   port_ufld.UFLDv2Spec(**SPEC_ARGS))
        jyolo = JaxYolo(model_path=npz_paths["yolo"], model_type=ObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, compute_dtype="int8")
        jlane = JaxLane(model_path=npz_paths["lane"], model_type=CULANE, dtype="int8")
        paths = {}
        for name, facade in (("yolo", jyolo), ("lane", jlane)):
            paths[name] = str(tmp / f"{name}_packed.npz")  # not *_int8.npz: the weight-only int8 store
            save_npz(paths[name], facade.variables)
        yolo = YoloDetector(model_path=paths["yolo"], model_type=PortObjectModelType.YOLOV8,
                            scale="n", input_size=YOLO_HW, box_score=0.25, compute_dtype="int8",
                            device="cpu")
        lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype="int8",
                                       device="cpu")
        assert all(m.xmax is None for m in yolo.net.modules() if hasattr(m, "xmax"))
        yield jyolo, jlane, yolo, lane


def test_dynamic_scale_is_per_batch_element():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 4, 5, 6)).astype(np.float32))
    x[1] *= 10
    s = dynamic_scale(x)
    assert s.shape == (3,)
    for i in range(3):
        assert s[i] == torch.clamp_min(x[i].abs().max(), 1e-12) / 127


def test_uncalibrated_int8_close_to_jax(packed):
    jyolo, jlane, yolo, lane = packed
    jms = JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW, transport="i420")
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport="i420")
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


@pytest.mark.parametrize("transport", ["bgr", "i420"])
def test_streams_are_independent(packed, transport):
    """Stream 0's packed row is the same to the bit whatever stream 1's
    frame is (one shared dynamic scale made it depend on stream 1's
    absmax)."""
    _, _, yolo, lane = packed
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport=transport)
    frames = _ticks(1, seed=3)[0]
    bright = frames.copy()
    bright[1] = 255 - bright[1] // 4  # a far larger absmax on stream 1
    a = ms._step(ms._prep_upload(frames))
    b = ms._step(ms._prep_upload(bright))
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])
    ms.close()


def test_compute_probe_is_the_carried_sum(packed):
    """``make_compute_probe(2)`` on the CPU: the sum of the packed outputs
    of the step on ``x`` and on ``x + 1`` (uint8, wrapping)."""
    _, _, yolo, lane = packed
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport="i420")
    x = ms._prep_upload(_ticks(1, seed=4)[0])
    want = ms._step(x).sum() + ms._step(x + 1).sum()
    got = ms.make_compute_probe(2)(x)
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, want)
    ms.close()


def test_serve_pipelined_upload_workers(packed):
    """Two upload workers give the same ordered per-tick signals as
    sequential ``process_batch`` ticks."""
    _, _, yolo, lane = packed

    def digest(results):
        return [([(o.label, round(o.conf, 5), o.tolist()) for o in r["objects"]],
                 r["tracks"], r["lanes_status"]) for r in results]

    ticks = _ticks(4, seed=11)
    seq = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW)
    expected = [digest(seq.process_batch(f)) for f in ticks]
    seq.close()
    pipe = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW)
    got = {}
    n = pipe.serve_pipelined(iter(ticks), depth=2, upload_workers=2,
                             on_result=lambda i, res: got.__setitem__(i, digest(res)))
    assert pipe._uploader._max_workers == 2
    pipe.close()
    assert n == len(ticks) and [got[i] for i in range(len(ticks))] == expected


def test_ufld_v1_int8_detect_frame_matches_jax(tmp_path, monkeypatch):
    jkey, key = JaxLaneModelType.UFLD_CULANE, LaneModelType.UFLD_CULANE
    jspec = dataclasses.replace(jufld.UFLDV1_SPECS[jkey], input_height=64, input_width=160,
                                mlp_mid=64)
    monkeypatch.setitem(jufld.UFLDV1_SPECS, jkey, jspec)
    monkeypatch.setitem(port_ufld.UFLDV1_SPECS, key, dataclasses.replace(
        port_ufld.UFLDV1_SPECS[key], input_height=64, input_width=160, mlp_mid=64))
    path = str(tmp_path / "v1.npz")
    save_npz(path, unflatten_variables(flax_weights(jufld.UFLDv1Net(jspec), (1, 64, 160, 3),
                                                       seed=2)))
    jv1 = JaxV1(model_path=path, model_type=jkey, dtype="int8")
    v1 = UltrafastLaneDetector(model_path=path, model_type=key, compute_dtype="int8",
                               device="cpu")
    frame = _ticks(1, seed=5)[0][0]
    want_loc = np.asarray(jv1._step(jv1.variables, jnp.asarray(frame))[0])
    got_loc = v1._step(torch.from_numpy(frame)).numpy()[0]

    # the logits the two steps decode (JAX's jitted, as its step runs them)
    x = jax_v1_preprocess(jnp.asarray(frame)[None], 64, 160, dtype=jnp.float32)

    def serve(variables, xx):
        with quantized("int8"):
            return jv1.net.apply(variables, xx)

    want = np.asarray(jax.jit(serve)(jv1.variables, x))
    with torch.no_grad():
        got = v1.net(ufld_v1_preprocess(frame, 64, 160, device="cpu")).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2

    found = (got_loc > 0) & (want_loc > 0)
    assert ((got_loc > 0) == (want_loc > 0)).mean() >= 0.95 and found.any()
    assert np.abs(got_loc - want_loc)[found].max() <= 0.01 * jspec.griding_num
    jv1.DetectFrame(frame)
    v1.DetectFrame(frame)
    assert v1.lane_info.lanes_status == jv1.lane_info.lanes_status
