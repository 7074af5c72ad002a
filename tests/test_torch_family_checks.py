"""Shared checks of the port's YOLOv5-lite, v6, v7 and v9 against the JAX
package (``tests/test_torch_yolo_{v5lite,v6,v7,v9}.py``), on the CPU.

One flax variable tree made from a numpy seed
(``test_torch_yolo_families.flax_weights``) goes into the JAX net and,
through the weight bridge, into the port's; a YOLOv6 tree is first put
in RepVGG's deploy form on both sides (``fuse_repvgg_variables`` and
``fuse_repvgg``), as both facades serve it.  Bounds as
``test_torch_yolo_families.py``: f32 boxes rtol 1e-3 with an atol of 1e-3
of the largest magnitude, probabilities atol 1e-4; bf16 and calibrated
int8 (JAX's scales carried across) relative L2 below 2e-2 per output.

A YOLOv6 tree's kernels are scaled by 0.6: with plain fan-in variance
v6's three-branch RepVGG sum triples its ReLU activations per block (to
~1e5 at the head), where logits of that size turn 1e-6 relative
differences into class probabilities 1e-3 apart, and where JAX's own
jitted and eager int8 outputs are 10% (relative L2) apart (XLA contracts
the epilogue's multiply-add into FMAs near requantize boundaries; on the
CPU, jax 0.9.0).  Scaled, the activations stay O(1).

Facades (``DetectFrame``): the score threshold sits in the widest gap
between the 5th and the 30th highest distinct scores of JAX's
detections on the first frame (random weights score every anchor alike,
so a fixed threshold would cut through near-ties); the detections are
then equal to JAX's: labels equal, boxes rtol 1e-4 with an atol of 1e-4
of the frame width, scores rtol 1e-4
(``test_torch_frame.assert_same_objects``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import yolo as jyolo
from adas_tpu.models import yolov6 as jyolov6
from adas_tpu.models.layers import QTensor as JaxQTensor
from adas_tpu.models.layers import quantized
from adas_tpu.models.yolov6 import fuse_repvgg_variables
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.models import yolo
from adas_tpu_torch.models.yolov6 import fuse_repvgg
from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector
from adas_tpu_torch.utils.types import ObjectModelType
from adas_tpu_torch.weights import load_flax_variables
from test_torch_frame import rows
from test_torch_int8_weights import _int8_buffers, _jax_leaves
from test_torch_models import save_npz
from test_torch_yolo_families import _close, _nchw, _rel, _tree, flax_weights

#: family -> its model type's name (both packages' enums)
TYPES = {"v5lite": "YOLOV5_LITE", "v6": "YOLOV6", "v7": "YOLOV7", "v9": "YOLOV9"}


def nets(family, scale, hw, int8=False):
    """The JAX net and the port's of one family, scale and input size."""
    jnet = jyolo.build_yolo(jyolo.YoloSpec(family, scale, 80, hw))
    return jnet, yolo.build_yolo(yolo.YoloSpec(scale, 80, hw, family=family), int8=int8)


def tree_for(jnet, family, hw, seed, fused=False):
    """The flat seeded tree (a YOLOv6's kernels x0.6, module docstring; its
    deploy form when ``fused``)."""
    flat = flax_weights(jnet, (1, *hw, 3), seed)
    if family == "v6":
        flat = {k: v * 0.6 if k.endswith("kernel") else v for k, v in flat.items()}
    if fused:
        flat = flatten_variables(fuse_repvgg_variables(unflatten_variables(flat)))
    return flat


def split(family, out):
    """(boxes, the rest) of an output: v8 contract (B, 4+nc, N), else
    (B, N, 5+nc)."""
    return (out[:, :4], out[:, 4:]) if family == "v9" else (out[..., :4], out[..., 4:])


def check_f32(family, scale, hw, fused=False):
    jnet, net = nets(family, scale, hw)
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    flat = tree_for(jnet, family, hw, 3, fused)
    want = np.asarray(jax.jit(jnet.apply)(_tree(flat), jnp.asarray(x)))
    if fused:
        fuse_repvgg(net)
    load_flax_variables(net.eval(), flat)
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    (gb, gp), (wb, wp) = split(family, got), split(family, want)
    _close(gb, wb)
    np.testing.assert_allclose(gp, wp, atol=1e-4)


def check_bf16(family, scale, hw):
    """bf16 (every floating leaf cast, ``tools/quantize.cast_params``; bf16
    input) against JAX's: relative L2 below 2e-2 per output (each side
    sits 1e-3 to 5e-3 from the f32 net, and the two as far apart)."""
    from adas_tpu.tools.quantize import cast_params

    jnet, net = nets(family, scale, hw)
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    fused = family == "v6"
    flat = tree_for(jnet, family, hw, 3, fused)
    want = np.asarray(jax.jit(jnet.apply)(cast_params(_tree(flat), "bf16"),
                                          jnp.asarray(x, jnp.bfloat16)), np.float32)
    if fused:
        fuse_repvgg(net)
    load_flax_variables(net, flat)
    net = net.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = net(_nchw(x, torch.bfloat16)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    (gb, gp), (wb, wp) = split(family, got), split(family, want)
    assert _rel(gb, wb) < 2e-2
    assert _rel(gp, wp) < 2e-2


def facade_pair(family, scale, path, hw, **kw):
    """(JAX facade, port facade) on one ``.npz``; the JAX one only when
    asked for (``jax_side=False`` gives None).  Every option a test may
    have set as a class default on its xdist worker is named on both sides
    (``tests/test_yolo.py`` sets the JAX facade's ``max_det`` to 20 and its
    ``box_score`` to 0.25 for the rest of its worker)."""
    jax_side = kw.pop("jax_side", True)
    named = {k: YOLO_OPTIONS[k] for k in ("classes_path", "box_score", "box_nms_iou", "max_det")}
    args = {**named, "model_path": path, "scale": scale, "input_size": hw, **kw}
    return (JaxYolo(model_type=getattr(JaxObjectModelType, TYPES[family]), **args)
            if jax_side else None,
            YoloDetector(model_type=getattr(ObjectModelType, TYPES[family]), device="cpu", **args))


def _threshold(scores):
    """A score threshold in the widest gap between consecutive ones of the
    5th to 30th highest distinct scores (module docstring)."""
    s = np.unique(scores)[::-1][:31]
    i = 5 + int(np.argmax(s[4:-1] - s[5:]))
    return float((s[i - 1] + s[i]) / 2)


def detect_pairs(family, scale, tmp_path, hw=(128, 128)):
    """The two f32 facades on one seeded tree, their score threshold set
    from the port's detections on a first 180x320 frame (module
    docstring; the JAX facade is built with it, so its step compiles
    once), and two frames to compare them on."""
    jnet, _ = nets(family, scale, hw)
    path = str(tmp_path / f"{family}.npz")
    save_npz(path, unflatten_variables(tree_for(jnet, family, hw, 5)))
    frames = np.random.default_rng(1).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
    probe = facade_pair(family, scale, path, hw, box_score=0.0, jax_side=False)[1]
    probe.DetectFrame(frames[0])
    return (*facade_pair(family, scale, path, hw,
                         box_score=_threshold(rows(probe.object_info)[2])), frames)


def same_objects(want, got) -> int:
    """``test_torch_frame.assert_same_objects`` at 320-px frames."""
    wl, wb, ws = rows(want)
    gl, gb, gs = rows(got)
    assert gl == wl
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4 * 320)
    np.testing.assert_allclose(gs, ws, rtol=1e-4)
    return len(gl)


def check_detect_frame(family, scale, tmp_path):
    """``DetectFrame`` of the two f32 facades on two 180x320 frames."""
    jax_side, port, frames = detect_pairs(family, scale, tmp_path)
    n = 0
    for f in frames:
        jax_side.DetectFrame(f)
        port.DetectFrame(f)
        n += same_objects(jax_side.object_info, port.object_info)
    assert n >= 5


def check_fused_step(family, scale, tmp_path, monkeypatch, transport):
    """``FusedADASStep`` of the two packages (``fused.py``) with the f32
    facades and UFLDv2 on ``test_torch_models``' reduced CULane spec (the
    JAX stems on their XLA chain, as ``test_torch_frame``): the same
    detections, and lanes equal.  On I420 a family without a planes stem
    decodes the frame to BGR planes first (``fused.py:143-217``)."""
    from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
    from adas_tpu.models.ufld import UFLDv2Net, UFLDv2Spec
    from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
    from adas_tpu.pipeline.fused import FusedADASStep as JaxFused
    from adas_tpu.utils.types import LaneModelType as JaxLaneModelType
    from adas_tpu_torch.models import ufld as port_ufld
    from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
    from adas_tpu_torch.pipeline.fused import FusedADASStep
    from test_torch_frame import lanes as lane_rows
    from test_torch_models import SPEC_ARGS, random_flax_weights

    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    monkeypatch.setitem(JAX_UFLD_SPECS, JaxLaneModelType.UFLDV2_CULANE, UFLDv2Spec(**SPEC_ARGS))
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        port_ufld.UFLDv2Spec(**SPEC_ARGS))
    lane_path = str(tmp_path / "lane.npz")
    shape = (1, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"], 3)
    save_npz(lane_path, unflatten_variables(
        random_flax_weights(UFLDv2Net(UFLDv2Spec(**SPEC_ARGS)), shape, seed=23)))
    jlane = JaxLane(model_path=lane_path, model_type=JaxLaneModelType.UFLDV2_CULANE)
    lane = UltrafastLaneDetectorV2(model_path=lane_path, device="cpu")
    jax_side, port, frames = detect_pairs(family, scale, tmp_path)
    jax_fused = JaxFused(jax_side, jlane, transport=transport)
    fused = FusedADASStep(port, lane, transport=transport)
    n = 0
    for f in frames:
        jax_fused.run(f)
        fused.run(f)
        n += same_objects(jax_side.object_info, port.object_info)
        assert lane_rows(lane.lane_info) == lane_rows(jlane.lane_info)
    assert n >= 5


def _int8_apply(jnet):
    """JAX's net under ``quantized("int8")``, as a function of (variables, x)."""
    def serve(v, x):
        with quantized("int8"):
            return jnet.apply(v, x)
    return serve


def _dequant_bottlerep():
    """JAX's ``BottleRep`` (``adas_tpu/models/yolov6.py:142``) with its
    ``alpha`` residual taken on ``x.dequant()`` where ``x`` is an s8
    ``QTensor``: the one change the port makes (its ``BottleRep``), for
    the witness of a calibrated v6 m/l.  Applied in the test only."""
    from flax import linen as nn

    class DequantBottleRep(jyolov6.BottleRep):
        @nn.compact
        def __call__(self, x, train: bool = False):
            y = jyolov6.RepVGGBlock(self.features, name="conv1")(x, train, emit_q=True)
            y = jyolov6.RepVGGBlock(self.features, name="conv2")(y, train)
            if x.shape[-1] == self.features:
                alpha = self.param("alpha", nn.initializers.ones, (1,), jnp.float32)
                y = y + alpha * (x.dequant() if isinstance(x, JaxQTensor) else x)
            return y

    return DequantBottleRep


def check_int8(family, scale, tmp_path, hw=(64, 64), rtol=2e-2, jax_serves=True):
    """The int8 facades on one seeded ``.npz`` (``test_torch_yolo_families``'
    packer check grown by the net's parity): the port packs exactly JAX's
    kernels, bit-equal; ``calibrate_int8`` on two BGR frames records the
    same scale keys (the named groups included) within ``rtol``; JAX's
    calibrated, packed tree loads whole into a new port net, which on a
    letterboxed frame in bf16 gives JAX's int8 net's output within
    relative L2 2e-2 per output.  ``jax_serves=False`` (v6 m/l, module
    ``test_torch_yolo_v6``): JAX's calibrated net raises; the witness the
    port is held to is JAX's net with BottleRep's residual on the bf16
    view of its s8 input (:func:`_dequant_bottlerep`, the port's
    BottleRep).  Returns (the number of packed kernels, JAX's calibrated
    flat tree)."""
    from adas_tpu.ops.preprocess import LetterboxGeometry as JaxGeometry
    from adas_tpu.ops.preprocess import yolo_preprocess as jax_yolo_preprocess

    jnet, _ = nets(family, scale, hw)
    path = str(tmp_path / f"{family}_w.npz")  # not *_int8.npz: JAX reads that as packed
    save_npz(path, unflatten_variables(tree_for(jnet, family, hw, 9)))
    jax_side, port = facade_pair(family, scale, path, hw, compute_dtype="int8")
    wscales = _jax_leaves(jax_side.variables, "wscales")
    params = _jax_leaves(jax_side.variables, "params")
    ours = _int8_buffers(port.net)
    packed = {k[: -len(".wscale")] for k in wscales}
    assert packed == {k[: -len(".wq")] for k in ours if k.endswith(".wq")}
    for k in packed:
        np.testing.assert_array_equal(ours[f"{k}.wq"].numpy(),
                                      np.asarray(params[f"{k}.kernel"]).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(ours[f"{k}.wscale"].numpy(),
                                      np.asarray(wscales[f"{k}.wscale"]).reshape(-1))
    frames = list(np.random.default_rng(3).integers(0, 256, (3, 90, 160, 3), dtype=np.uint8))
    port.calibrate_int8(frames[:2])
    jax_side.calibrate_int8(frames[:2])
    want = _jax_leaves(jax_side.variables, "act_scales")
    got = {k: v for k, v in _int8_buffers(port.net).items() if not k.endswith((".wq", ".wscale"))}
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) / float(v) - 1) < rtol, k
    cal_flat = flatten_variables(jax_side.variables)
    net = yolo.build_yolo(port.spec, int8=True)
    if family == "v6":
        fuse_repvgg(net)
    load_flax_variables(net, cal_flat)
    bufs = _int8_buffers(net)
    for coll in ("act_scales", "wscales"):
        for k, v in _jax_leaves(jax_side.variables, coll).items():
            np.testing.assert_array_equal(bufs[k].numpy().reshape(-1),
                                          np.asarray(v, np.float32).reshape(-1))
    x = np.asarray(jax_yolo_preprocess(jnp.asarray(frames[2])[None],
                                       JaxGeometry(90, 160, *hw), dtype=jnp.float32))
    serve, xj = _int8_apply(jax_side.net), jnp.asarray(x, jnp.bfloat16)
    if jax_serves:
        want_out = np.asarray(jax.jit(serve)(jax_side.variables, xj), np.float32)
    else:
        with pytest.raises(TypeError):  # traced abstractly: the error is at trace time
            jax.eval_shape(serve, jax_side.variables, xj)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jyolov6, "BottleRep", _dequant_bottlerep())
            want_out = np.asarray(jax.jit(serve)(jax_side.variables, xj), np.float32)
    net.eval().requires_grad_(False)
    with torch.no_grad():
        got_out = net(_nchw(x, torch.bfloat16)).float().numpy()
    assert got_out.shape == want_out.shape and np.isfinite(got_out).all()
    (gb, gp), (wb, wp) = split(family, got_out), split(family, want_out)
    assert _rel(gb, wb) < 2e-2
    assert _rel(gp, wp) < 2e-2
    return len(packed), cal_flat
