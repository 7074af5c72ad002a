"""The port's whole serving slice against the JAX package.

Two streams of I420-transported frames go through the JAX
``MultiStreamADAS(transport="i420")`` and the port's, on the same weights
(one ``params_io`` ``.npz`` per net, loaded by both facades), for two
ticks: YOLOv8n at 160x160 and UFLDv2 (ResNet-18) on a reduced CULane spec
(64x160 input, fewer cells, a 64-wide MLP; ``num_row`` stays 72).  The
JAX stems run their parity-pinned XLA chain
(``ADAS_DISABLE_PALLAS_STEM=1``), the port's their plain CPU version.

Also: the port imports and serves one tick in a process where ``jax`` and
``flax`` cannot be imported, in bf16 and calibrated int8.
"""
import enum
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import LaneModelType, ObjectModelType
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from test_torch_models import SPEC_ARGS, random_flax_weights, save_npz

FRAME_HW = (180, 320)
YOLO_HW = (160, 160)
CULANE = LaneModelType.UFLDV2_CULANE


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory):
    """One params_io .npz per net (random weights from a numpy seed)."""
    tmp = tmp_path_factory.mktemp("weights")
    paths = {}
    for name, net, shape in (
        ("yolo", JaxYoloV8(JaxYoloSpec("v8", "n", 80, YOLO_HW)), (1, *YOLO_HW, 3)),
        ("lane", JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)),
         (1, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"], 3)),
    ):
        flat = random_flax_weights(net, shape, seed=len(name))
        if name == "yolo":
            # a random deep SiLU net forgets its input (each layer halves
            # the signal), leaving near-equal scores whose order is f32
            # noise; a 1.5x kernel gain keeps the scores content-driven,
            # and a wide, negatively biased class predictor spreads them
            # (about 280 candidates per frame, gaps above 1e-6)
            for k in flat:
                if k.endswith("kernel") and not k.endswith("_2::kernel"):
                    flat[k] *= 1.5
                elif "::cls" in k and k.endswith("_2::kernel"):
                    flat[k] *= 10.0
                elif "::cls" in k and k.endswith("_2::bias"):
                    flat[k][:] = -5.0
        paths[name] = str(tmp / f"{name}.npz")
        save_npz(paths[name], unflatten_variables(flat))
    return paths


@pytest.fixture
def weights(npz_paths, monkeypatch):
    """The reduced CULane spec on both sides, and the weight files."""
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    monkeypatch.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
    monkeypatch.setitem(
        port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
        port_ufld.UFLDv2Spec(**SPEC_ARGS),
    )
    return npz_paths


def signal(v):
    """A per-stream signal in a form both packages share: their enums are
    separate classes (each package has its own ``utils/types.py``), so an
    enum member compares by name and value."""
    return (type(v).__name__, v.name, v.value) if isinstance(v, enum.Enum) else v


def _ticks(n_ticks, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8) for _ in range(n_ticks)]


def _run_both(weights, bf16):
    import jax.numpy as jnp

    jyolo = JaxYolo(
        model_path=weights["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
        input_size=YOLO_HW, box_score=0.25, compute_dtype="bf16" if bf16 else None,
    )
    jlane = JaxLane(
        model_path=weights["lane"], model_type=CULANE,
        dtype=jnp.bfloat16 if bf16 else jnp.float32,
    )
    cd = "bf16" if bf16 else None
    yolo = YoloDetector(
        model_path=weights["yolo"], model_type=PortObjectModelType.YOLOV8, scale="n",
        input_size=YOLO_HW, box_score=0.25,
        compute_dtype=cd, device="cpu",
    )
    lane = UltrafastLaneDetectorV2(model_path=weights["lane"], compute_dtype=cd, device="cpu")
    jms = JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW, transport="i420")
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=FRAME_HW, transport="i420")
    ticks = _ticks(2)
    out = [(jms.process_batch(f), ms.process_batch(f)) for f in ticks]
    ms.close()
    return out


def _dets(result):
    objs = result["objects"]
    return (
        [o.label for o in objs],
        np.array([[o.x, o.y, o.x + o.width, o.y + o.height] for o in objs]).reshape(-1, 4),
        np.array([o.conf for o in objs]),
    )


def test_slice_f32_matches_jax(weights):
    n_dets = 0
    for want_tick, got_tick in _run_both(weights, bf16=False):
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
    assert n_dets > 0  # the scenario actually detects something


def _best_match(box, label, score, wb, wl, ws):
    """IoU of ``box`` with its best-overlapping JAX detection, and whether
    that one has the same label and a score within 0.03."""
    lt = np.maximum(box[:2], wb[:, :2])
    rb = np.minimum(box[2:], wb[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = (wb[:, 2] - wb[:, 0]) * (wb[:, 3] - wb[:, 1])
    iou = inter / ((box[2] - box[0]) * (box[3] - box[1]) + area - inter)
    j = int(np.argmax(iou))
    return iou[j], wl[j] == label and abs(ws[j] - score) < 0.03


def test_slice_bf16_close_to_jax(weights):
    """bf16 rounds at other places in the two frameworks (the port casts
    every weight to bf16, JAX keeps the lane net's weights f32 and
    computes in bf16), and these random weights amplify differences, so
    NMS can keep a neighbour of the JAX box and near-threshold boxes come
    and go.  Stated bounds, per stream and tick: detection counts within
    20% (+2); at least 60% of the port's detections match a JAX detection
    at IoU > 0.8 with the same label and a score within 0.03; the number
    of points of each lane within 2."""
    n_dets = 0
    for want_tick, got_tick in _run_both(weights, bf16=True):
        for want, got in zip(want_tick, got_tick):
            wl, wb, ws = _dets(want)
            gl, gb, gs = _dets(got)
            assert abs(len(gl) - len(wl)) <= 0.2 * len(wl) + 2
            assert np.all(np.isfinite(gb)) and np.all((gs > 0.25) & (gs <= 1))
            matches = [_best_match(b, lab, sc, wb, wl, ws) for lab, b, sc in zip(gl, gb, gs)]
            assert sum(iou > 0.8 and same for iou, same in matches) >= 0.6 * len(gl)
            for gp, wp in zip(got["lanes_points"], want["lanes_points"]):
                assert abs(len(gp) - len(wp)) <= 2
            n_dets += len(gl)
    assert n_dets > 0


def test_serve_pipelined_matches_sequential(monkeypatch):
    """The port's 3-stage pipeline gives the same ordered per-tick signals
    as sequential ``process_batch`` ticks (``multistream.py:642``)."""
    monkeypatch.setitem(
        port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
        port_ufld.UFLDv2Spec(**SPEC_ARGS),
    )

    def build():
        yolo = YoloDetector(model_type=PortObjectModelType.YOLOV8, scale="n",
                            input_size=(96, 96), box_score=0.25, device="cpu")
        return MultiStreamADAS(yolo, UltrafastLaneDetectorV2(device="cpu"), 2, frame_hw=FRAME_HW,
                               transport="i420")

    def digest(results):
        return [
            ([(o.label, round(o.conf, 5), o.tolist()) for o in r["objects"]],
             r["tracks"], r["lanes_status"])
            for r in results
        ]

    ticks = _ticks(4, seed=11)
    seq = build()
    expected = [digest(seq.process_batch(f)) for f in ticks]
    seq.close()
    pipe = build()
    got = {}
    n = pipe.serve_pipelined(
        iter(ticks), depth=2, on_result=lambda i, res: got.__setitem__(i, digest(res))
    )
    pipe.close()
    assert n == len(ticks) and sorted(got) == list(range(len(ticks)))
    assert [got[i] for i in range(len(ticks))] == expected
    assert all(s.tracker.frame_id == len(ticks) for s in pipe.streams)


#: the start of a script that cannot import ``jax``, ``jaxlib`` or ``flax``
BLOCK_JAX = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _Block())
    """
)

NO_JAX_SCRIPT = BLOCK_JAX + textwrap.dedent(
    """
    import numpy as np
    from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = ufld.UFLDv2Spec(**%r)
    yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=(96, 96),
                        box_score=0.25, device="cpu")
    lane = UltrafastLaneDetectorV2(device="cpu")
    ms = MultiStreamADAS(yolo, lane, 2, frame_hw=(180, 320), transport="i420")
    frames = np.random.default_rng(0).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
    out = ms.process_batch(frames)
    ms.close()
    # the calibrated int8 slice: the port's packer and calibrator, one tick
    yolo8 = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=(96, 96),
                         box_score=0.25, compute_dtype="int8", device="cpu")
    lane8 = UltrafastLaneDetectorV2(compute_dtype="int8", device="cpu")
    yolo8.calibrate_int8(list(frames))
    lane8.calibrate_int8(list(frames))
    ms8 = MultiStreamADAS(yolo8, lane8, 2, frame_hw=(180, 320), transport="i420")
    out8 = ms8.process_batch(frames)
    ms8.close()
    assert len(out) == len(out8) == 2 and not any(
        m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules
    )
    print("served", sum(len(r["objects"]) for r in out), sum(len(r["objects"]) for r in out8))
    """
    % (SPEC_ARGS,)
)


def run_without_jax(script: str) -> str:
    """Run ``script`` (starting with :data:`BLOCK_JAX`) in a fresh Python
    process from the repository root; returns its standard output."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(  # one torch thread, as the test process has
        [sys.executable, "-c", script], cwd=repo, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_port_serves_without_jax():
    assert run_without_jax(NO_JAX_SCRIPT).startswith("served")
