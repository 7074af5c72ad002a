"""The port's int8 modules against the JAX package under
``quantized("int8")``, with JAX's calibrated variable tree carried across
(``weights.load_flax_variables``): BasicBlock, Bottleneck, C2f, SPPF,
ResNet-18 features, UFLDv2 and YOLOv8n at 160x160.

Weights are random from a numpy seed; JAX calibrates on two inputs
(``tools/quantize.calibrate_act_scales``) and the port loads those scales,
so both sides quantize at the same static scales.  Bound: the relative
L2 error of each output against JAX's is below 2e-2 (the s32 accumulators
are exact on both sides).  The nets with a stem (ResNet-18 features,
UFLDv2) reach 2.3e-2 at their deepest outputs: the JAX int8 stem is an
XLA bf16 conv + bf16 BatchNorm, the port's the fused stem kernel's f32
epilogue with one rounding, and an s8 value that moves by one LSB moves
everything after it.  Those take 3e-2, with the port's own int8 error
against the f32 net within 1.1x of JAX's (the two are equally far from
f32: both about 3.2e-2 at ResNet's stride-32 tap).

The fused block engages only at the gate's sizes (>= 80x80 pixels, <= 64
channels), where the JAX default serves the XLA path off-TPU; there the
port's fused path is held to ``tests/test_pallas_block_integration.py``'s
yardstick: its error against the f32 net within 1.3x the unfused int8
error (the fused body skips the bf16 rounding of conv2's output before
the residual add, ``yolo.py:140-148``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import resnet as jresnet
from adas_tpu.models import yolo as jyolo
from adas_tpu.models.layers import QTensor as JQTensor
from adas_tpu.models.layers import quantized
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu.tools.quantize import calibrate_act_scales
from adas_tpu_torch.models import resnet, yolo
from adas_tpu_torch.models.quant import QTensor, as_float
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.ops import block as port_block
from adas_tpu_torch.weights import load_flax_variables
from test_torch_models import SPEC_ARGS, random_flax_weights


def _calibrated(net, shape, xs, seed, **call):
    """Random weights, then JAX's calibration over ``xs``; returns the
    calibrated tree and its flat form."""
    flat = random_flax_weights(net, shape, seed)
    variables = jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))
    cal = calibrate_act_scales(
        lambda v, x: net.apply(v, x, mutable=["act_scales"], **call), variables, xs)
    return cal, flatten_variables(cal)


def _serve_jax(net, cal, x, jit=False, **call):
    def f(v, xx):
        with quantized("int8"):
            return net.apply(v, xx, **call)
    return (jax.jit(f) if jit else f)(cal, x)


def _np(y):
    if isinstance(y, JQTensor):
        y = y.dequant()
    if isinstance(y, (torch.Tensor, QTensor)):
        return as_float(y).float().numpy()
    return np.asarray(y, np.float32)


def rel_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nhwc(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _port(module, flat):
    load_flax_variables(module, flat)
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("stride,cin,features", [(1, 32, 32), (2, 32, 64)])
def test_basic_block(rng, stride, cin, features):
    jx, px = _nhwc(rng, (2, 12, 20, cin))
    xs = [_nhwc(rng, (2, 12, 20, cin))[0], jx]
    net = jresnet.BasicBlock(features=features, strides=stride)
    cal, flat = _calibrated(net, (1, 12, 20, cin), xs, seed=1)
    want = _serve_jax(net, cal, jx)
    port = _port(resnet.BasicBlock(cin, features, stride, int8=True), flat)
    with torch.no_grad():
        got = port(px)
    assert rel_err(got, want) < 2e-2


@pytest.mark.parametrize("shortcut", [True, False])
def test_bottleneck(rng, shortcut):
    jx, px = _nhwc(rng, (2, 10, 14, 32))
    net = jyolo.Bottleneck(32, shortcut, expansion=1.0)
    cal, flat = _calibrated(net, (1, 10, 14, 32), [jx], seed=2)
    want = _serve_jax(net, cal, jx)
    port = _port(yolo.Bottleneck(32, 32, shortcut, int8=True), flat)
    with torch.no_grad():
        got = port(px)
    assert rel_err(got, want) < 2e-2


@pytest.mark.parametrize("emit_q", [False, True])
def test_c2f_s8_group(rng, emit_q):
    """cv1 emits at the group scale, the split halves stay s8, each
    bottleneck exit emits at it, and cv2 reads the s8 concat."""
    jx, px = _nhwc(rng, (2, 10, 12, 32))
    net = jyolo.C2f(32, n=2, shortcut=True)
    cal, flat = _calibrated(net, (1, 10, 12, 32), [jx], seed=3, emit_q=emit_q)
    assert "act_scales::concat_xmax" in flat
    want = _serve_jax(net, cal, jx, emit_q=emit_q)
    port = _port(yolo.C2f(32, 32, 2, True, int8=True), flat)
    with torch.no_grad():
        got = port(px, emit_q=emit_q)
    assert isinstance(got, tuple) == emit_q == isinstance(want, JQTensor)
    if emit_q:
        diff = np.abs(got.data.numpy().astype(int) - np.asarray(want.data, int))
        assert diff.max() <= 1 and (diff != 0).mean() < 5e-3
    assert rel_err(got, want) < 2e-2


def test_sppf_pools_in_s8(rng):
    jx, px = _nhwc(rng, (2, 6, 8, 64))
    net = jyolo.SPPF(64)
    cal, flat = _calibrated(net, (1, 6, 8, 64), [jx], seed=4)
    want = _serve_jax(net, cal, jx)
    port = _port(yolo.SPPF(64, 64, int8=True), flat)
    with torch.no_grad():
        got = port(px)
    assert rel_err(got, want) < 2e-2


def test_resnet_features(rng):
    x = rng.standard_normal((2, 64, 160, 3)).astype(np.float32)
    jx = jnp.asarray(x)
    net = jresnet.ResNetFeatures(depth="18")
    cal, flat = _calibrated(net, (1, 64, 160, 3), [jx], seed=5)
    want = _serve_jax(net, cal, jx.astype(jnp.bfloat16), jit=True)
    port = _port(resnet.ResNetFeatures("18", int8=True), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16))
    f32 = net.apply({k: cal[k] for k in ("params", "batch_stats")}, jx)
    for g, w, r in zip(got, want, f32):
        assert rel_err(g, w) < 3e-2
        assert rel_err(g, r) < 1.1 * rel_err(w, r)


def test_ufld_v2(rng):
    x = rng.standard_normal((2, 64, 160, 3)).astype(np.float32)
    net = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS))
    cal, flat = _calibrated(net, (1, 64, 160, 3), [jnp.asarray(x[:1]), jnp.asarray(x[1:])],
                            seed=6)
    assert "act_scales::cls_fc2::xmax" in flat
    want = _serve_jax(net, cal, jnp.asarray(x, jnp.bfloat16), jit=True)
    port = _port(UFLDv2Net(UFLDv2Spec(**SPEC_ARGS), int8=True), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16))
    f32 = net.apply({k: cal[k] for k in ("params", "batch_stats")}, jnp.asarray(x))
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) < 3e-2
        assert rel_err(got[k], f32[k]) < 1.1 * rel_err(want[k], f32[k])


def test_yolov8n(rng):
    hw = (160, 160)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    net = jyolo.YoloV8(jyolo.YoloSpec("v8", "n", 80, hw))
    cal, flat = _calibrated(net, (1, *hw, 3), [jnp.asarray(x[:1]), jnp.asarray(x[1:])], seed=7)
    groups = [k for k in flat if k.endswith(("concat_xmax", "neck_a_xmax", "neck_b_xmax"))]
    assert len(groups) == 11  # 8 C2f + SPPF + the two neck groups: 13 concats
    want = np.asarray(_serve_jax(net, cal, jnp.asarray(x, jnp.bfloat16), jit=True))
    port = _port(yolo.YoloV8(yolo.YoloSpec("n", 80, hw), int8=True), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)).numpy()
    assert got.shape == want.shape
    assert rel_err(got[:, :4], want[:, :4]) < 2e-2  # xywh
    assert rel_err(got[:, 4:], want[:, 4:]) < 2e-2  # class probabilities


def _f32_ref(net, cal, x, **call):
    params = {k: v for k, v in cal.items() if k in ("params", "batch_stats")}
    return np.asarray(net.apply(params, x.astype(jnp.float32), **call), np.float32)


def _mean_err(got, ref):
    return float(np.abs(_np(got) - ref).mean() / np.abs(ref).mean())


def test_fused_basic_block_within_yardstick(rng, monkeypatch):
    """A ResNet layer1 body at 80x80x64: the port fuses it (the CPU runs
    the plain block), JAX serves the unfused XLA path.  The fused body
    emits s8 at ``out_ymax``'s scale, which the next conv would apply to
    the unfused bf16 output anyway, so the unfused error is taken after
    that same quantize."""
    calls = []
    monkeypatch.setattr(resnet, "fused_block",
                        lambda *a, **k: calls.append(1) or port_block.fused_block(*a, **k))
    jx, px = _nhwc(rng, (1, 80, 80, 64))
    net = jresnet.BasicBlock(features=64)
    cal, flat = _calibrated(net, (1, 80, 80, 64), [jx], seed=8)
    assert "act_scales::out_ymax" in flat
    unfused = _serve_jax(net, cal, jx, jit=True)
    port = _port(resnet.BasicBlock(64, 64, 1, int8=True), flat)
    with torch.no_grad():
        fused = port(px)
    assert len(calls) == 1 and isinstance(fused, tuple)
    so = np.maximum(np.float32(flat["act_scales::out_ymax"]), 1e-12) / np.float32(127)
    unfused = np.clip(np.round(_np(unfused) / so), -127, 127) * so
    ref = _f32_ref(net, cal, jx)
    assert _mean_err(fused, ref) < 1.3 * _mean_err(unfused, ref) + 1e-4


def test_fused_bottleneck_within_yardstick(rng, monkeypatch):
    """A C2f whose bottleneck body (80x80, 64 channels, in a concat group)
    passes the gate: the port fuses it, JAX serves XLA."""
    calls = []
    monkeypatch.setattr(yolo, "fused_block",
                        lambda *a, **k: calls.append(1) or port_block.fused_block(*a, **k))
    jx, px = _nhwc(rng, (1, 80, 80, 64))
    net = jyolo.C2f(128, n=1, shortcut=True)
    cal, flat = _calibrated(net, (1, 80, 80, 64), [jx], seed=9)
    unfused = _serve_jax(net, cal, jx, jit=True)
    port = _port(yolo.C2f(64, 128, 1, True, int8=True), flat)
    with torch.no_grad():
        fused = port(px)
    assert len(calls) == 1
    ref = _f32_ref(net, cal, jx)
    assert _mean_err(fused, ref) < 1.3 * _mean_err(unfused, ref) + 1e-4
