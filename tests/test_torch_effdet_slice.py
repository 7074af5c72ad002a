"""The port's EfficientDet serving slice against the JAX package.

Two streams of I420-transported 180x320 frames go through the JAX
``MultiStreamADAS(EfficientdetDetector, UltrafastLaneDetectorV2,
transport="i420")`` and the port's, on the same weights (one ``params_io``
``.npz`` per net, loaded by both facades), for two ticks: EfficientDet-D0
at full width on a 128x128 input, and UFLDv2 (ResNet-18) on the reduced
CULane spec of ``test_torch_slice.py``.  On this path both sides decode
the I420 batch into rounded BGR planes and feed both nets from them.  The
JAX stems run their parity-pinned XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``),
the port's their plain CPU version.  On gray frames (neutral chroma, U = V = 128) detections must match as
in ``test_torch_slice.py``: labels equal in order, boxes within 1e-2,
scores within 1e-4; tracks, lanes and the per-stream signals equal.

Colour frames cannot be held that tightly.  The JAX step is one jitted
program, and XLA contracts the BT.601 products and sums of
``i420_to_bgr_planar`` into fused multiply-adds: a few values in 1e4
round to the other side of .5 and land one level off the literal
formula, which the port and eager JAX evaluate
(``test_torch_preprocess.py`` holds those two equal to the bit).
:func:`test_colour_decode_gap_is_xla_fma` shows the gap and its cause;
:func:`test_effdet_slice_colour_matches_jax` holds the colour pipeline
against JAX at tolerances that gap allows.  With neutral chroma every
chroma product is zero and both decodes are exact.

Also: the port's batched detections equal its own single-frame
``DetectFrame``, and the port serves an EfficientDet tick in a process
that cannot import ``jax`` or ``flax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import efficientdet as jax_effdet
from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.ops import preprocess as jax_preprocess
from adas_tpu.perception.efficientdet_detector import EfficientdetDetector as JaxEffdet
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import LaneModelType
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.ops.preprocess import bgr_to_i420, i420_to_bgr_planar
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from test_torch_efficientdet import live_trunk, random_tree
from test_torch_models import SPEC_ARGS, random_flax_weights, save_npz
from test_torch_slice import BLOCK_JAX, _dets, _ticks, run_without_jax, signal

FRAME_HW = (180, 320)
SIZE = 128
BOX_SCORE = 0.5
MAX_DET = 100
# colour frames: the one-level decode gap moves scores by up to 3.9e-4
# and box corners by up to 4.5e-2 px (16 frames, seeds 5-8); these hold
# about twice that
COLOUR_SCORE_TOL = 1e-3
COLOUR_BOX_TOL = 0.1
COLOUR_IOU_TOL = 5e-3
NMS_IOU = 0.5  # EfficientdetDetector's box_nms_iou
CULANE = LaneModelType.UFLDV2_CULANE


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory):
    """One params_io .npz per net (random weights from a numpy seed)."""
    tmp = tmp_path_factory.mktemp("weights")
    net = jax_effdet.EfficientDet(jax_effdet.EfficientDetSpec(compound=0, num_classes=80))
    flat = live_trunk(random_tree(net, [jnp.zeros((1, SIZE, SIZE, 3))], seed=3))
    # a wider, negatively biased class predictor spreads the scores: about
    # 18 detections per frame above BOX_SCORE
    flat["params::classifier::header::pw::kernel"] *= 5.0
    flat["params::classifier::header::pw::bias"][:] = -2.0
    lane = random_flax_weights(
        JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)),
        (1, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"], 3), seed=4,
    )
    paths = {"effdet": str(tmp / "effdet.npz"), "lane": str(tmp / "lane.npz")}
    save_npz(paths["effdet"], unflatten_variables(flat))
    save_npz(paths["lane"], unflatten_variables(lane))
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


def _gray_ticks(n_ticks, seed):
    """Ticks of two gray-noise frames (B = G = R)."""
    return [np.repeat(t[..., :1], 3, axis=-1) for t in _ticks(n_ticks, seed)]


def _port_pipeline(weights):
    det = EfficientdetDetector(model_path=weights["effdet"], compound=0, input_size=SIZE,
                               box_score=BOX_SCORE, device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=weights["lane"], device="cpu")
    return det, MultiStreamADAS(det, lane, 2, frame_hw=FRAME_HW, transport="i420")


def test_effdet_slice_matches_jax(weights):
    jdet = JaxEffdet(model_path=weights["effdet"], compound=0, input_size=SIZE,
                     box_score=BOX_SCORE)
    jlane = JaxLane(model_path=weights["lane"], model_type=CULANE)
    jms = JaxMultiStream(jdet, jlane, 2, frame_hw=FRAME_HW, transport="i420")
    det, ms = _port_pipeline(weights)
    assert det.spec.input_size == SIZE and len(det.class_names) == 80
    n_dets = 0
    for frames in _gray_ticks(2, seed=5):
        want_tick, got_tick = jms.process_batch(frames), ms.process_batch(frames)
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
    ms.close()
    assert n_dets > 0  # the scenario actually detects something


def _fma(a, b, c):
    """``a*b + c`` rounded to f32 once (f64 holds the f32 product exactly)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def test_colour_decode_gap_is_xla_fma():
    """The port's colour I420 decode against the jitted JAX one: at most
    one level apart, on fewer than 1e-3 of the values.  The cause: the
    jitted B and R planes equal the BT.601 formula with each ``yy + k*c``
    rounded once, as a fused multiply-add rounds it."""
    h, w = FRAME_HW
    f32 = np.float32
    jit_decode = jax.jit(jax.vmap(lambda y: jax_preprocess.i420_to_bgr_planar(y, h, w)))
    for frames in _ticks(2, seed=5):
        yuv = np.stack([bgr_to_i420(f) for f in frames])
        got = i420_to_bgr_planar(torch.from_numpy(yuv), h, w).numpy()
        want = np.asarray(jit_decode(jnp.asarray(yuv)))
        gap = np.abs(got - want)
        assert gap.max() <= 1.0
        assert (gap > 0).mean() < 1e-3
        y = yuv[:, :h].astype(f32)
        uu, vv = (
            yuv[:, a:a + h // 4].reshape(-1, h // 2, w // 2).astype(f32)
            .repeat(2, axis=1).repeat(2, axis=2) - f32(128.0)
            for a in (h, h + h // 4)
        )
        yy = f32(1.164) * (y - f32(16.0))
        for plane, (k, c) in ((0, (2.018, uu)), (2, (1.596, vv))):
            fused = np.clip(np.round(_fma(f32(k), c, yy)), 0.0, 255.0)
            np.testing.assert_array_equal(want[:, plane], fused)


def _nms_iou(box, others, geom):
    """VOC (+1) IoU of one source-frame box against others, in the
    letterboxed coordinates where the NMS compared them."""
    (rh, rw), (ph, pw) = geom.scale_ratio, geom.pad
    to_nms = np.array([1 / rw, 1 / rh, 1 / rw, 1 / rh])
    shift = np.array([pw, ph, pw, ph])
    a = box * to_nms + shift
    b = others.reshape(-1, 4) * to_nms + shift
    iw = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + 1, 0, None)
    area = lambda x: (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1] + 1)
    inter = iw * ih
    return inter / (area(a) + area(b) - inter)


def _match_colour(want, got, geom):
    """Pair each JAX detection with a port one of the same label, score
    within COLOUR_SCORE_TOL and box within COLOUR_BOX_TOL; near-tied
    scores may come out in another order.  Every detection left without
    a partner must trace back to a cut that the decode gap can move a
    detection across:

    - a score within COLOUR_SCORE_TOL of ``box_score``, or of the last
      kept score of a list full at ``max_det``;
    - a detection the other side kept that overlaps it past the NMS
      threshold with a score within COLOUR_SCORE_TOL (a near tie that NMS
      broke the other way), or that was kept before it and overlaps it
      within COLOUR_IOU_TOL of the threshold;
    - or, in turn, an unpaired detection of the other side, so explained,
      that was kept before it and overlaps it past the threshold (the
      greedy scan carries one flip on to the boxes that flip suppressed).

    Returns the number of paired detections."""
    sides = _dets(want), _dets(got)
    (wl, wb, ws), (gl, gb, gs) = sides
    free = list(range(len(gl)))
    lonely = ([], [])
    for i in range(len(wl)):
        j = next((j for j in free if gl[j] == wl[i] and abs(gs[j] - ws[i]) <= COLOUR_SCORE_TOL
                  and np.abs(gb[j] - wb[i]).max() <= COLOUR_BOX_TOL), None)
        if j is None:
            lonely[0].append(i)
        else:
            free.remove(j)
    lonely[1].extend(free)
    explained = (set(), set())
    for a in (0, 1):
        (_, boxes, scores), (_, oboxes, oscores) = sides[a], sides[1 - a]
        cuts = [BOX_SCORE] + ([scores.min()] if len(scores) == MAX_DET else [])
        for i in lonely[a]:
            iou = _nms_iou(boxes[i], oboxes, geom)
            gap = oscores - scores[i]
            tie = (np.abs(gap) <= COLOUR_SCORE_TOL) & (iou > NMS_IOU - COLOUR_IOU_TOL)
            edge = (gap >= -COLOUR_SCORE_TOL) & (np.abs(iou - NMS_IOU) <= COLOUR_IOU_TOL)
            if min(abs(scores[i] - c) for c in cuts) <= COLOUR_SCORE_TOL or np.any(tie | edge):
                explained[a].add(i)
    grew = True
    while grew:
        grew = False
        for a in (0, 1):
            (_, boxes, scores), (_, oboxes, oscores) = sides[a], sides[1 - a]
            for i in set(lonely[a]) - explained[a]:
                for k in explained[1 - a]:
                    if (oscores[k] >= scores[i] - COLOUR_SCORE_TOL
                            and _nms_iou(boxes[i], oboxes[k], geom)[0] > NMS_IOU - COLOUR_IOU_TOL):
                        explained[a].add(i)
                        grew = True
                        break
    for a in (0, 1):
        unexplained = set(lonely[a]) - explained[a]
        assert not unexplained, [(sides[a][0][i], sides[a][2][i]) for i in sorted(unexplained)]
    return len(wl) - len(lonely[0])


def test_effdet_slice_colour_matches_jax(weights):
    """Colour frames through both pipelines: detections paired within the
    decode gap's tolerances, lanes and signals equal."""
    jdet = JaxEffdet(model_path=weights["effdet"], compound=0, input_size=SIZE,
                     box_score=BOX_SCORE)
    jlane = JaxLane(model_path=weights["lane"], model_type=CULANE)
    jms = JaxMultiStream(jdet, jlane, 2, frame_hw=FRAME_HW, transport="i420")
    _, ms = _port_pipeline(weights)
    n_paired = 0
    for frames in _ticks(2, seed=5):
        for want, got in zip(jms.process_batch(frames), ms.process_batch(frames)):
            n_paired += _match_colour(want, got, ms.geom)
            assert got["lanes_status"] == want["lanes_status"]
            for gp, wp in zip(got["lanes_points"], want["lanes_points"]):
                assert list(gp) == list(wp)
            for key in ("collision", "offset", "curvature", "area_status"):
                assert signal(got[key]) == signal(want[key])
    ms.close()
    assert n_paired > 100


def test_batched_detections_equal_detect_frame(weights):
    """Per stream, the pipeline's detections equal ``DetectFrame`` on the
    frame the I420 transport delivers (``tests/test_multistream.py:309``)."""
    det, ms = _port_pipeline(weights)
    frames = _gray_ticks(1, seed=6)[0]
    results = ms.process_batch(frames)
    ms.close()
    n = 0
    for frame, res in zip(frames, results):
        yuv = torch.from_numpy(bgr_to_i420(frame))[None]
        seen = i420_to_bgr_planar(yuv, *FRAME_HW)[0].permute(1, 2, 0).to(torch.uint8).numpy()
        det.DetectFrame(seen)
        # one frame against a batch of two: the convolutions sum in
        # another order, so the scores agree to f32 noise
        assert [o.label for o in det.object_info] == [o.label for o in res["objects"]]
        np.testing.assert_allclose([o.conf for o in det.object_info],
                                   [o.conf for o in res["objects"]], atol=1e-6)
        np.testing.assert_allclose([o.tolist() for o in det.object_info],
                                   [o.tolist() for o in res["objects"]], atol=1e-3)
        n += len(det.object_info)
    assert n > 0


NO_JAX_EFFDET_SCRIPT = BLOCK_JAX + (
    """
import numpy as np
from adas_tpu_torch.utils.types import LaneModelType
from adas_tpu_torch.models import ufld
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.tools import nms_ab  # noqa: F401  the A/B tool imports no jax either

ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE] = ufld.UFLDv2Spec(**%r)
det = EfficientdetDetector(compound=0, input_size=128, box_score=0.05, device="cpu")
ms = MultiStreamADAS(det, UltrafastLaneDetectorV2(device="cpu"), 2, frame_hw=(180, 320),
                     transport="i420")
frames = np.random.default_rng(0).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
out = ms.process_batch(frames)
ms.close()
det.DetectFrame(frames[0])
assert len(out) == 2 and not any(
    m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules
)
print("served", sum(len(r["objects"]) for r in out), len(det.object_info))
"""
    % (SPEC_ARGS,)
)


def test_port_serves_effdet_without_jax():
    assert run_without_jax(NO_JAX_EFFDET_SCRIPT).startswith("served")
