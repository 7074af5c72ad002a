"""The port's ONNX exporter (``adas_tpu_torch/tools/onnx_export.py``, a
``torch.export`` graph walker) and ``MultiStreamADAS`` over an ONNX-served
YOLO facade (``pipeline/multistream._ExecutorNet``) against the JAX
package's (``adas_tpu/tools/onnx_export.py``,
``adas_tpu/pipeline/multistream.py:61-102``).

Weights: the random flax trees of ``test_torch_slice`` (YOLOv8n at
160x160, UFLDv2 on the reduced CULane spec), loaded into both packages.
Bounds: a graph the port exported, run by either package's
``OnnxGraphEngine``, against the port's net within JAX's rtol = atol =
2e-4 (``tests/test_onnx_export.py:118``), and against JAX's net within
the two frameworks' f32 bound of ``test_torch_models`` (rtol 1e-3, atol
1e-3 of the largest magnitude).  The CLIs' input and output names, shapes
and types equal JAX's CLI's for the same ``--model``.  The ONNX-served
2-stream ticks hold the bound of ``test_torch_multistream_bgr``
(labels and tracks identical, boxes within 1e-2 px, scores within 1e-4,
lanes identical) against the native tick and JAX's ``_ExecutorNet`` tick.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.engine.onnx_engine import OnnxGraphEngine as JaxOnnxEngine
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu.tools import onnx_export as JOE
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.engine.onnx_engine import OnnxGraphEngine
from adas_tpu_torch.engine.torch_engine import FakeEngine
from adas_tpu_torch.models.quant import pack_int8_weights
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.models.yolo import YoloSpec, YoloV8
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS, _ExecutorNet
from adas_tpu_torch.tools import onnx_export as OE
from adas_tpu_torch.tools import onnx_writer as W
from adas_tpu_torch.tools.onnx_graph import parse_onnx
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from adas_tpu_torch.weights import init_params, load_flax_variables, load_npz
from test_torch_models import SPEC_ARGS, _close, random_flax_weights, save_npz
from test_torch_multistream_bgr import _assert_f32_ticks_match
from test_torch_slice import FRAME_HW, YOLO_HW, _dets, _ticks, npz_paths, weights

__all__ = ["npz_paths", "weights"]  # fixtures shared with the slice tests

EXPORT_TOL = dict(rtol=2e-4, atol=2e-4)


def _nets(name, paths):
    """(port net, JAX net, flat tree, NCHW input) for ``name``."""
    flat = load_npz(paths[name])
    if name == "yolo":
        net, jnet = YoloV8(YoloSpec("n", 80, YOLO_HW)), JaxYoloV8(JaxYoloSpec("v8", "n", 80, YOLO_HW))
        shape = (2, 3, *YOLO_HW)
    else:
        net, jnet = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS)), JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS))
        shape = (2, 3, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"])
    load_flax_variables(net.eval(), flat)
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    return net, jnet, flat, x


@pytest.mark.parametrize("name", ["yolo", "lane"])
def test_export_matches_both_nets_through_both_executors(name, npz_paths, tmp_path):
    net, jnet, flat, x = _nets(name, npz_paths)
    path = str(tmp_path / f"{name}.onnx")
    info = OE.export_module_to_onnx(net, torch.from_numpy(x), path, ["images"])
    assert info["inputs"] == ["images"] and info["n_initializers"] > 20
    with torch.no_grad():
        port = net(torch.from_numpy(x))
    jax_out = jax.jit(jnet.apply)(jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat)),
                                  jnp.asarray(x.transpose(0, 2, 3, 1)))
    if isinstance(port, dict):  # the graph's outputs in the port's key order
        jax_out = [np.asarray(jax_out[k]) for k in port]
        port = [v.numpy() for v in port.values()]
    else:
        port, jax_out = [port.numpy()], [np.asarray(jax_out)]
    for engine in (OnnxGraphEngine(path, batch_size=2, device="cpu"), JaxOnnxEngine(path)):
        got = engine.engine_inference(x)
        assert len(got) == len(port)
        for g, p, j in zip(got, port, jax_out):
            g = np.asarray(g)
            assert g.shape == p.shape == j.shape
            np.testing.assert_allclose(g, p, **EXPORT_TOL)
            _close(g, j)


def _io(path):
    g = parse_onnx(path).graph
    return ([(v.name, tuple(v.shape), np.dtype(v.dtype)) for v in g.data_inputs],
            [(v.name, tuple(v.shape), np.dtype(v.dtype)) for v in g.outputs])


def test_cli_matches_jax_cli(tmp_path):
    """``--model yolov8_n --weights w.npz``: the same graph inputs and
    outputs as JAX's CLI writes, and the same numbers from both files."""
    flat = random_flax_weights(JaxYoloV8(JaxYoloSpec("v8", "n", 80, (640, 640))),
                               (1, 640, 640, 3), seed=4)
    weights = str(tmp_path / "v8n.npz")
    save_npz(weights, unflatten_variables(flat))
    ours, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    OE.main(["--model", "yolov8_n", "--weights", weights, "--device", "cpu", "-o", ours])
    JOE.main(["--model", "yolov8_n", "--weights", weights, "-o", theirs])
    assert _io(ours) == _io(theirs) == (
        [("images", (1, 3, 640, 640), np.dtype(np.float32))],
        [("output0", (1, 84, 8400), np.dtype(np.float32))])
    x = np.random.default_rng(5).uniform(0, 1, (1, 3, 640, 640)).astype(np.float32)
    got = OnnxGraphEngine(ours, device="cpu").engine_inference(x)[0]
    want = np.asarray(JaxOnnxEngine(theirs).engine_inference(x)[0])
    _close(got, want)
    net = _load_v8n(weights)
    with torch.no_grad():
        np.testing.assert_allclose(got, net(torch.from_numpy(x)).numpy(), **EXPORT_TOL)


def _load_v8n(path):
    net = YoloV8(YoloSpec("n", 80, (640, 640))).eval()
    load_flax_variables(net, load_npz(path))
    return net


@pytest.mark.parametrize("model", ["ufldv2_tusimple", "ufldv1_tusimple"])
def test_cli_builders_match_jax_contracts(model, monkeypatch):
    """The UFLD CLI models: the builder's input, output names and output
    shapes equal JAX's (JAX's side abstract: ``jax.eval_shape``)."""
    def zeros(net, x, w):  # no init: the tree's shapes, filled with zeros
        tree = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), tree)

    monkeypatch.setattr(JOE, "_load_or_init", zeros)
    jfn, jex, jnames = JOE._build_export(model, None)
    want = jax.eval_shape(jfn, jex)
    want = [tuple(v.shape) for v in (want if isinstance(want, tuple) else [want])]
    fn, ex, names = OE._build_export(model, None, device="cpu")
    with torch.no_grad():
        out = fn(ex)
    got = [tuple(v.shape) for v in (out if isinstance(out, tuple) else [out])]
    assert names == jnames and tuple(ex.shape) == tuple(jex.shape) and got == want


def test_int8_net_raises():
    """The int8 operators have no ONNX form, as a ``pallas_call`` has none
    in JAX's walker (``tests/test_onnx_export.py:79``)."""
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS), int8=True)
    init_params(net)
    pack_int8_weights(net)
    x = torch.zeros(1, 3, SPEC_ARGS["input_height"], SPEC_ARGS["input_width"])
    with pytest.raises(OE.ExportError, match="int8"):
        OE.export_module_to_onnx(net, x, "/dev/null")


def test_unsupported_op_raises():
    class Cum(torch.nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 0)

    with pytest.raises(OE.ExportError, match="cumsum"):
        OE.export_module_to_onnx(Cum(), torch.ones(4, 4), "/dev/null")


def test_ops_round_trip(tmp_path):
    """Softmax, reduce, slice, permute, layer norm, linear, nearest and
    bilinear upsampling, pooling and the folded constants through both
    executors."""
    class Ops(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = torch.nn.LayerNorm(8)
            self.fc = torch.nn.Linear(8, 5)

        def forward(self, x):
            s = torch.softmax(x, dim=-1)
            r = x.sum(dim=1)
            sl = x[:, 1:5, ::2]
            p = x.permute(0, 2, 1) * torch.arange(6, dtype=torch.float32)
            fc = self.fc(torch.relu(self.norm(x)))
            up = torch.nn.functional.interpolate(x[:, None], scale_factor=2, mode="nearest")
            pool = torch.nn.functional.max_pool2d(up, 3, 2, 1)
            bil = torch.nn.functional.interpolate(x[:, None], scale_factor=4, mode="bilinear",
                                                  align_corners=False)
            return (s, r, sl, p, fc, torch.sigmoid(pool) - x.mean(dim=(1, 2), keepdim=True)[:, None],
                    bil)

    a = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 6, 8)).astype(np.float32))
    m = Ops().eval()
    want = [t.detach().numpy() for t in m(a)]
    path = str(tmp_path / "ops.onnx")
    OE.export_module_to_onnx(m, a, path, ["x"])
    for engine in (OnnxGraphEngine(path, batch_size=2, device="cpu"), JaxOnnxEngine(path)):
        for g, w in zip(engine.engine_inference(a.numpy()), want):
            np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-6)


# ---- MultiStreamADAS over an ONNX-served facade --------------------------


@pytest.fixture
def onnx_yolo(weights, tmp_path):
    net, _, _, _ = _nets("yolo", weights)
    path = str(tmp_path / "v8n.onnx")
    OE.export_module_to_onnx(net, torch.zeros(1, 3, *YOLO_HW), path, ["images"], ["output0"])
    return path


def _facades(paths, onnx_path):
    kw = dict(model_type=PortObjectModelType.YOLOV8, box_score=0.25, device="cpu")
    served = YoloDetector(model_path=onnx_path, onnx_mode="graph", **kw)
    native = YoloDetector(model_path=paths["yolo"], scale="n", input_size=YOLO_HW, **kw)
    return served, native, UltrafastLaneDetectorV2(model_path=paths["lane"], device="cpu")


@pytest.mark.parametrize("transport", ["bgr", "i420"])
def test_onnx_served_multistream_matches_native(weights, onnx_yolo, transport):
    """On I420 the served graph takes the decoded BGR planes, as JAX's
    ``stem_s2d_ok = False`` routes it; the native v8n, which takes the
    YUV-direct planes, is routed the same way here to see the same input."""
    served, native, lane = _facades(weights, onnx_yolo)
    native.net.stem_takes_planes = False
    ms = MultiStreamADAS(served, lane, 2, FRAME_HW, transport=transport)
    assert isinstance(served.net, _ExecutorNet) and served.net.stem_takes_planes is False
    _assert_f32_ticks_match(MultiStreamADAS(native, lane, 2, FRAME_HW, transport=transport), ms)


def test_onnx_served_multistream_matches_jax(weights, onnx_yolo):
    """JAX's ``_ExecutorNet`` tick over the same file (JAX's default
    transport, bgr)."""
    served, _, lane = _facades(weights, onnx_yolo)
    from test_torch_multistream_bgr import _jax_pair

    _, jlane = _jax_pair(weights)
    jyolo = JaxYolo(model_path=onnx_yolo, model_type=ObjectModelType.YOLOV8, onnx_mode="graph",
                    box_score=0.25)
    _assert_f32_ticks_match(JaxMultiStream(jyolo, jlane, 2, frame_hw=FRAME_HW),
                            MultiStreamADAS(served, lane, 2, FRAME_HW))
    frames = _ticks(1, seed=9)[0]
    assert len(_dets(MultiStreamADAS(served, lane, 2, FRAME_HW).process_batch(frames)[0])[0]) > 0


def test_executor_net_refuses_other_engines_and_host_tails(weights):
    """JAX's errors: an engine that is not the graph executor (TypeError),
    a graph with a host tail (ValueError)."""
    with pytest.raises(TypeError, match="OnnxGraphEngine"):
        _ExecutorNet(FakeEngine((1, 3, 160, 160), {"output0": np.zeros((1, 84, 525))}))
    tail = OnnxGraphEngine(parse_onnx(W.simple_model(
        [W.make_node("NonZero", ["x"], ["y"])], [("x", np.float32, (1, 4))],
        [("y", np.int64, None)])), device="cpu")
    with pytest.raises(ValueError, match="host tail"):
        _ExecutorNet(tail)
    fake = YoloDetector(model_type=PortObjectModelType.YOLOV8, device="cpu",
                        engine=FakeEngine((1, 3, 160, 160), {"output0": np.zeros((1, 84, 525))}))
    lane = UltrafastLaneDetectorV2(model_path=weights["lane"], device="cpu")
    with pytest.raises(TypeError, match="OnnxGraphEngine"):
        MultiStreamADAS(fake, lane, 2, FRAME_HW)
