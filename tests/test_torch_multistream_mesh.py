"""The port's ``MultiStreamADAS`` over a mesh of devices against the JAX
package's on its 8-virtual-device CPU mesh, and against the port's own
unsharded pipeline.

JAX's multistream mesh test (``tests/test_multistream.py``) serves YOLOv8n
at 160x160 and UFLDv2-TuSimple on 180x320 frames; here the object side is
the same and the lane net is ``test_torch_slice``'s reduced CULane spec
(64x160 input, a 64-wide MLP): the mesh keeps a replica of both nets per
data row in the port and per device in JAX, and eight copies of the
TuSimple head (2048 x 39,576 f32, 324 MB) in each framework would not fit
beside the other test workers.  The weights are ``test_torch_slice``'s
(random from a numpy seed, the YOLO trunk's scores spread), one
``params_io`` ``.npz`` per net loaded by both packages; the JAX stems run
their XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``), the port's their plain
CPU version.  One JAX run, on ``make_mesh(8)`` (data 4, model 2; JAX
replicates the parameters over ``model``, so its (8, 1) mesh runs the
same per-stream program), serves 8 streams for two ticks on JAX's
default transport, bgr.

Bounds: against JAX, ``test_torch_multistream_bgr``'s per stream and
tick (labels and track counts identical, boxes within 1e-2 px, scores
within 1e-4, lane points and signals identical).  Against the port's
unsharded pipeline: each data row's streams equal, to the bit, the
unsharded step on those streams (2 per row on (4, 2), 1 on (8, 1)), and
the whole tick is within rtol 1e-5, atol 1e-4 of the unsharded 8-stream
step.  Not to the bit: torch's CPU f32 GEMM (``F.linear``, the UFLD head)
picks its kernel by the number of rows, and at 1 or 2 rows it rounds
otherwise than at 8 (up to 9.5e-7 in ``cls_fc1``), as the YOLOv8
convolutions do at batch 1 (9.2e-5 px at most, on box corners).  A
calibrated int8 tick on 2 rows (exact integer products) equals the
unsharded 2-stream one to the bit.
"""
import numpy as np
import pytest
import torch

from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.parallel import make_mesh as jax_make_mesh
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.parallel import Mesh, make_mesh
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from test_torch_models import SPEC_ARGS
from test_torch_multistream_bgr import MAX_DET
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, _dets, npz_paths, signal

__all__ = ["npz_paths"]  # the weight-file fixture, shared with the slice tests

N = 8
MESHES = {"4x2": 2, "8x1": 1}


def ticks(n_ticks=2, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (N, *FRAME_HW, 3), dtype=np.uint8) for _ in range(n_ticks)]


def cpu_mesh(model_parallel):
    return make_mesh(8, model_parallel=model_parallel, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def specs(npz_paths):
    """The reduced CULane spec on both sides and the JAX stems' XLA chain,
    for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
        mp.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                   port_ufld.UFLDv2Spec(**SPEC_ARGS))
        yield npz_paths


@pytest.fixture(scope="module")
def jax_run(specs):
    """Two ticks of 8 streams through JAX's pipeline on ``make_mesh(8)``."""
    mesh = jax_make_mesh(8)
    assert mesh.devices.shape == (4, 2)
    jyolo = JaxYolo(model_path=specs["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
                    input_size=YOLO_HW, box_score=0.25, max_det=MAX_DET)
    jlane = JaxLane(model_path=specs["lane"], model_type=CULANE)
    jms = JaxMultiStream(jyolo, jlane, N, frame_hw=FRAME_HW, mesh=mesh)
    return [jms.process_batch(f) for f in ticks()]


def port_pair(paths, compute_dtype=None):
    yolo = YoloDetector(model_path=paths["yolo"], model_type=PortObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, max_det=MAX_DET,
                        compute_dtype=compute_dtype, device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=paths["lane"], compute_dtype=compute_dtype,
                                   device="cpu")
    return yolo, lane


@pytest.fixture(scope="module")
def pair(specs):
    return port_pair(specs)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_ticks_match_jax(jax_run, pair, shape):
    """Each stream's detections, tracks, lanes and signals, tick by tick."""
    mesh = cpu_mesh(MESHES[shape])
    ms = MultiStreamADAS(*pair, N, FRAME_HW, mesh=mesh)
    n_dets = 0
    for frames, want_tick in zip(ticks(), jax_run):
        got_tick = ms.process_batch(frames)
        assert len(got_tick) == N
        for want, got in zip(want_tick, got_tick):
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
    # each stream's tracker advanced on its own, once per tick
    assert [s.tracker.frame_id for s in ms.streams] == [2] * N
    assert len({id(s.tracker) for s in ms.streams}) == N
    ms.close()
    assert n_dets > 0


@pytest.fixture(scope="module")
def unsharded(pair):
    """The port's unsharded pipeline on tick 0: its 8-stream step, and its
    step on each part of 2 and of 1 streams."""
    ms = MultiStreamADAS(*pair, N, FRAME_HW)
    x = ms._prep_upload(ticks()[0])
    parts = {k: np.concatenate([ms._step(x[i:i + k]).numpy() for i in range(0, N, k)])
             for k in (1, 2)}
    return ms._step(x).numpy(), parts


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_tick_equals_unsharded(pair, unsharded, shape):
    """One packed row per stream from one ``.cpu()`` per data row: each
    row's rows equal to the bit to the unsharded step on that row's
    streams, and within rtol 1e-5, atol 1e-4 of the 8-stream step (the
    module doc)."""
    mesh = cpu_mesh(MESHES[shape])
    rows = mesh.axis_size("data")
    ms = MultiStreamADAS(*pair, N, FRAME_HW, mesh=mesh)
    handle = ms.submit(ticks()[0])
    assert len(handle) == rows
    assert [h.shape[0] for h in handle] == [N // rows] * rows
    got = np.concatenate([h.numpy() for h in handle])
    batch, parts = unsharded
    np.testing.assert_array_equal(got, parts[N // rows])
    np.testing.assert_allclose(got, batch, rtol=1e-5, atol=1e-4)
    ms.close()


def test_streams_are_independent(pair):
    """A stream's packed row depends on its own frame only: changing the
    frames of the other rows' streams leaves it as it was."""
    ms = MultiStreamADAS(*pair, N, FRAME_HW, mesh=cpu_mesh(2))
    frames = ticks()[0]
    other = frames.copy()
    other[2:] = 255 - other[2:]
    a = np.concatenate([h.numpy() for h in ms.submit(frames)])
    b = np.concatenate([h.numpy() for h in ms.submit(other)])
    np.testing.assert_array_equal(a[:2], b[:2])
    assert not np.array_equal(a[2:], b[2:])
    ms.close()


def test_probe_and_pipelined_serving_on_a_mesh(pair):
    """The compute probe sums the rows' chained steps; ``serve_pipelined``
    with two upload workers gives the signals of ``process_batch``."""
    mesh = cpu_mesh(2)
    ms = MultiStreamADAS(*pair, N, FRAME_HW, mesh=mesh)
    frames = ticks(2)
    x = ms.prefetch(frames[0]).result()
    assert [p.device.type for p in x] == ["cpu"] * 4
    want = sum(float(ms._step(x)[r].sum()) + float(ms._step([p + 1 for p in x])[r].sum())
               for r in range(4))
    assert float(ms.make_compute_probe(2)(x)) == pytest.approx(want, rel=1e-5)
    seq = MultiStreamADAS(*pair, N, FRAME_HW, mesh=mesh)
    want_sig = [[(len(r["objects"]), r["tracks"], r["lanes_status"]) for r in seq.process_batch(f)]
                for f in frames]
    got_sig = {}
    ms.serve_pipelined(iter(frames), on_result=lambda i, out: got_sig.update(
        {i: [(len(r["objects"]), r["tracks"], r["lanes_status"]) for r in out]}),
        upload_workers=2)
    assert [got_sig[i] for i in range(2)] == want_sig
    ms.close()
    seq.close()


def test_mesh_rules(pair, tmp_path):
    """Streams that do not split over the data rows, a mesh that is not a
    ``Mesh``, and ``export_fused`` of a multi-device pipeline raise (JAX's
    reason); a CUDA mesh without a card raises as the facades do."""
    with pytest.raises(ValueError, match="split evenly"):
        MultiStreamADAS(*pair, 6, FRAME_HW, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="mesh"):
        MultiStreamADAS(*pair, N, FRAME_HW, mesh=object())
    ms = MultiStreamADAS(*pair, N, FRAME_HW, mesh=cpu_mesh(1))
    with pytest.raises(ValueError, match="serialize device assignments"):
        ms.export_fused(str(tmp_path / "p.adas"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Mesh([["cuda:0"], ["cuda:0"]])


def test_calibrated_int8_two_rows_equal_unsharded(specs):
    """Calibrated int8 on a (2, 1) mesh that repeats the CPU: the tick
    equals the unsharded one to the bit, and each row's replica carries
    the calibration."""
    yolo, lane = port_pair(specs, "int8")
    calib = list(ticks(1, seed=5)[0][:2])
    yolo.calibrate_int8(calib)
    lane.calibrate_int8(calib)
    mesh = Mesh([["cpu"], ["cpu"]])
    assert mesh.repeats
    frames = ticks()[0][:2]
    want = MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport="i420").submit(frames).numpy()
    ms = MultiStreamADAS(yolo, lane, 2, FRAME_HW, mesh=mesh, transport="i420")
    views = ms._views
    assert views[0][0].net is not views[1][0].net and views[0][0].net is not yolo.net
    got = np.concatenate([h.numpy() for h in ms.submit(frames)])
    np.testing.assert_array_equal(got, want)
    ms.close()


def test_step_artifact_on_a_mesh(pair, tmp_path):
    """A pipeline on a one-device mesh exports its step; served with
    ``step_artifact=`` on a (2, 1) mesh the artifact runs the whole batch
    on the mesh's first device, as JAX's single-device artifact does, and
    gives the native tick to the bit."""
    frames = ticks()[0][:2]
    path = str(tmp_path / "mesh.adas")
    MultiStreamADAS(*pair, 2, FRAME_HW, mesh=Mesh([["cpu"]])).export_fused(path)
    served = MultiStreamADAS(*pair, 2, FRAME_HW, mesh=Mesh([["cpu"], ["cpu"]]),
                             step_artifact=path)
    handle = served.submit(frames)
    assert isinstance(handle, torch.Tensor) and served._rows is None
    want = MultiStreamADAS(*pair, 2, FRAME_HW).submit(frames)
    np.testing.assert_array_equal(handle.numpy(), want.numpy())
    assert len(served.process_batch(frames)) == 2


def test_other_object_sides_and_dynamic_int8_on_a_mesh(specs):
    """EfficientDet's object side on I420 with ``host_downscale``, and
    uncalibrated int8 (a dynamic scale per stream) on bgr, over a (2, 1)
    mesh: each row equal to the unsharded pipeline's step on its stream,
    to the bit."""
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector

    det = EfficientdetDetector(compound=0, input_size=128, box_score=0.5, device="cpu", seed=0)
    lane = UltrafastLaneDetectorV2(model_path=specs["lane"], device="cpu")
    frames = ticks()[0][:2]
    for pipeline, kw in (((det, lane), dict(transport="i420", host_downscale=(100, 176))),
                         (port_pair(specs, "int8"), dict(transport="bgr"))):
        plain = MultiStreamADAS(*pipeline, 2, FRAME_HW, **kw)
        x0 = plain._prep_upload(frames)
        want = np.concatenate([plain._step(x0[i:i + 1]).numpy() for i in range(2)])
        ms = MultiStreamADAS(*pipeline, 2, FRAME_HW, mesh=Mesh([["cpu"], ["cpu"]]), **kw)
        np.testing.assert_array_equal(np.concatenate([h.numpy() for h in ms.submit(frames)]),
                                      want)
        assert len(ms.process_batch(frames)) == 2
