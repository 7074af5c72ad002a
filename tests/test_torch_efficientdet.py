"""The port's EfficientDet (``adas_tpu_torch/models/efficientdet.py``)
against the flax one on the same weights, through the weight bridge.

Weights are random from a numpy seed (kernels with fan-in variance,
BatchNorm statistics and affines away from identity, BiFPN fusion weights
in [0.2, 1.5], in the BiFPN tests with one negative to exercise the ReLU;
the full net's trunk
kernels scaled so that its output depends on the image), carried as the
flat ``params_io`` dict.  f32; tolerance rtol 1e-4 with an atol of 1e-4 of the
output's largest magnitude (the two frameworks' convolutions sum in other
orders).  Anchors are exact; ``decode_boxes`` is exact except that the two
frameworks' ``exp`` differ by an ulp on some inputs (rtol 1e-6 and an atol
of 1e-6 of the largest coordinate there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import efficientdet as J
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu_torch.models import efficientdet as P
from adas_tpu_torch.weights import init_params, load_flax_variables, state_dict_from_flax

SIZE = 128


def random_tree(net, inputs, seed, fusion_negative=None):
    """A flat ``::``-keyed numpy variable dict for flax ``net`` applied to
    ``inputs`` (shapes only, via ``eval_shape``)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(net.init, jax.random.PRNGKey(0), *inputs)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}::{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            elif P._FUSIONS and any(k == name for name, _ in P._FUSIONS):
                a = rng.uniform(0.2, 1.5, shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            flat[path] = a.astype(np.float32)

    walk(tree, "")
    if fusion_negative is not None:
        flat[fusion_negative][1] = -0.5
    return flat


def live_trunk(flat):
    """Scale the trunk's kernels by 1.5 in place: with plain fan-in
    variance a random 16-block SiLU trunk forgets its input (two inputs
    give C5 maps 1e-4 apart, relative), and the net's output would not
    depend on the image.  Returns ``flat``."""
    for k in flat:
        if k.startswith("params::backbone::") and k.endswith("::kernel"):
            flat[k] *= 1.5
    return flat


def _apply_jax(net, flat, *inputs):
    variables = jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))
    return jax.jit(net.apply)(variables, *inputs)


def _port(module, flat):
    load_flax_variables(module, flat)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _close_nchw(got, want):
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def d0():
    """EfficientDet-D0 at full width, 80 classes, on a 128x128 input: one
    flax tree and one JAX forward for the module."""
    net = J.EfficientDet(J.EfficientDetSpec(compound=0, num_classes=80))
    x = np.random.default_rng(0).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    flat = live_trunk(random_tree(net, [jnp.zeros((1, SIZE, SIZE, 3))], seed=1))
    boxes, probs = _apply_jax(net, flat, jnp.asarray(x))
    return flat, x, np.asarray(boxes), np.asarray(probs)


def test_anchors_exact():
    for size, scale in ((128, 4.0), (512, 4.0), (1536, 5.0)):
        want = J.build_anchors(size, scale)
        np.testing.assert_array_equal(P.build_anchors(size, scale), want)
        got = P._anchors_on(size, scale, "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    assert P.build_anchors(512).shape == (49104, 4)


def test_decode_boxes():
    anchors = J.build_anchors(SIZE)
    reg = np.random.default_rng(2).normal(0, 0.5, (2, anchors.shape[0], 4)).astype(np.float32)
    a_j, a_p = jnp.asarray(anchors, jnp.float32), P._anchors_on(SIZE, 4.0, "cpu")
    want = np.asarray(J.decode_boxes(jnp.asarray(reg), a_j))
    got = P.decode_boxes(torch.from_numpy(reg), a_p).numpy()
    # an ulp of exp in w / 2 survives the cancellation in cx - w / 2 as a
    # few ulps of the frame's coordinates
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
    reg[..., 2:] = 0.0  # no exp term: exact
    want = np.asarray(J.decode_boxes(jnp.asarray(reg), a_j))
    np.testing.assert_array_equal(P.decode_boxes(torch.from_numpy(reg), a_p).numpy(), want)


def test_compound_table_d0_d7():
    """As ``tests/test_efficientdet.py``: block counts per backbone, input
    sizes, anchor scales, D6's head row."""
    expected_blocks = {0: 16, 1: 23, 2: 23, 3: 26, 4: 32, 5: 39, 6: 45, 7: 45}
    expected_inputs = {0: 512, 1: 640, 2: 768, 3: 896, 4: 1024, 5: 1280, 6: 1280, 7: 1536}
    assert P._D_CONFIGS == J._D_CONFIGS
    for d, (w, dep, *_rest) in P._D_CONFIGS.items():
        assert len(P.mbconv_plan(w, dep)) == expected_blocks[d]
        assert P.mbconv_plan(w, dep) == J.mbconv_plan(w, dep)
        spec = P.EfficientDetSpec(compound=d)
        assert spec.input_size == expected_inputs[d]
        assert spec.anchor_scale == (5.0 if d == 7 else 4.0)
        assert spec.anchor_scale == J.EfficientDetSpec(compound=d).resolved_anchor_scale
    assert P._D_CONFIGS[6][3:] == (384, 8, 5)
    assert P.EfficientDetSpec(input_size_override=256).input_size == 256
    with pytest.raises(ValueError, match="multiple of 128"):
        _ = P.EfficientDetSpec(input_size_override=200).input_size


@pytest.mark.parametrize("hw", [(9, 9), (10, 13), (16, 16)])
def test_same_pool_pads_with_zeros(hw):
    x = np.random.default_rng(3).standard_normal((2, *hw, 5)).astype(np.float32) - 1.0
    want = np.asarray(J._same_pool(jnp.asarray(x)))
    got = P.same_pool(_nchw(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("cin,features,expand,kernel,stride", [
    (32, 16, 1, 3, 1),    # block0: no expand
    (24, 24, 6, 3, 1),    # residual
    (24, 40, 6, 5, 2),    # 5x5/2, TF-SAME bottom/right padding
    (40, 80, 6, 3, 2),
])
def test_mbconv_matches_flax(cin, features, expand, kernel, stride):
    net = J.MBConv(features, expand, kernel, stride)
    x = np.random.default_rng(4).standard_normal((2, 15, 16, cin)).astype(np.float32)
    flat = random_tree(net, [jnp.zeros((1, 15, 16, cin))], seed=5)
    want = _apply_jax(net, flat, jnp.asarray(x))
    got = _port(P.MBConv(cin, features, expand, kernel, stride), flat)(_nchw(x))
    _close_nchw(got.detach(), want)


def _pyramid(rng, channels, size=32):
    """(P3..P7) NHWC maps of a ``size`` input's strides 8..128... at the
    sizes a 4*size input gives them."""
    return [rng.standard_normal((2, size >> i, size >> i, c)).astype(np.float32)
            for i, c in enumerate(channels)]


@pytest.mark.parametrize("first_time", [True, False])
def test_bifpn_layer_matches_flax(first_time):
    rng = np.random.default_rng(6)
    feats = _pyramid(rng, (40, 112, 320) if first_time else (64,) * 5, size=16)
    net = J.BiFPNLayer(64, first_time=first_time)
    flat = random_tree(net, [tuple(jnp.zeros((1, *f.shape[1:])) for f in feats)], seed=7,
                       fusion_negative="params::p4_w2")
    want = _apply_jax(net, flat, tuple(jnp.asarray(f) for f in feats))
    port = P.BiFPNLayer(64, first_time=first_time,
                        in_channels=(40, 112, 320) if first_time else ())
    got = _port(port, flat)([_nchw(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close_nchw(g.detach(), w)


def test_bifpn_plain_sum_for_d6_d7():
    """``attention=False`` (D6/D7): no fusion weights, a plain sum."""
    rng = np.random.default_rng(8)
    feats = _pyramid(rng, (16,) * 5, size=16)
    net = J.BiFPNLayer(16, attention=False)
    flat = random_tree(net, [tuple(jnp.zeros((1, *f.shape[1:])) for f in feats)], seed=9)
    assert not any("_w" in k.split("::")[-1] for k in flat)
    want = _apply_jax(net, flat, tuple(jnp.asarray(f) for f in feats))
    got = _port(P.BiFPNLayer(16, attention=False), flat)([_nchw(f) for f in feats])
    for g, w in zip(got, want):
        _close_nchw(g.detach(), w)


def test_prediction_head_matches_flax():
    rng = np.random.default_rng(10)
    feats = _pyramid(rng, (64,) * 5, size=16)
    net = J.PredictionHead(64, 3, 9 * 80)
    flat = random_tree(net, [tuple(jnp.zeros((1, *f.shape[1:])) for f in feats)], seed=11)
    want = _apply_jax(net, flat, tuple(jnp.asarray(f) for f in feats))
    got = _port(P.PredictionHead(64, 3, 9 * 80), flat)([_nchw(f) for f in feats])
    for g, w in zip(got, want):
        _close_nchw(g.detach(), w)


def test_efficientdet_d0_matches_flax(d0):
    flat, x, want_boxes, want_probs = d0
    net = _port(P.EfficientDet(P.EfficientDetSpec(compound=0, num_classes=80)), flat)
    with torch.inference_mode():
        boxes, probs = net(_nchw(x))
    n = sum((SIZE // 2 ** level) ** 2 * 9 for level in range(3, 8))
    assert boxes.shape == (2, n, 4) and probs.shape == (2, n, 80)
    _close(boxes.numpy(), want_boxes)
    _close(probs.numpy(), want_probs)
    # the weights keep the output content-driven: the two inputs' class
    # probabilities differ far beyond the tolerance
    assert float(np.abs(want_probs[0] - want_probs[1]).max()) > 0.05


def test_weight_bridge_maps_every_leaf_once(d0):
    """Every flax leaf has exactly one counterpart, and every parameter and
    statistic of the port is covered: depthwise (kh, kw, 1, C) kernels as
    (C, 1, kh, kw), fusion weights as parameters, the per-level BN lists."""
    flat = d0[0]
    net = P.EfficientDet(P.EfficientDetSpec(compound=0, num_classes=80))
    sd = state_dict_from_flax(flat)
    own = {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert len(sd) == len(flat) and set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    dw = flat["params::backbone::block3::dw_conv::kernel"]
    assert dw.shape == (5, 5, 1, 144)
    np.testing.assert_array_equal(sd["backbone.block3.dw_conv.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bifpn1.p5_w2"].numpy(), flat["params::bifpn1::p5_w2"])
    assert "classifier.bn_l4_c2.running_var" in sd


def test_seeded_init_fusion_weights_ones():
    """The port's seeded init follows flax's: fusion weights ones, BN at
    identity, biases zero; one seed gives one set of weights."""
    a = P.EfficientDet(P.EfficientDetSpec(compound=0, num_classes=4))
    b = P.EfficientDet(P.EfficientDetSpec(compound=0, num_classes=4))
    init_params(a, seed=3)
    init_params(b, seed=3)
    for (_, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb)
    assert torch.equal(a.bifpn2.p4_w2, torch.ones(3))
    assert torch.equal(a.regressor.header.pw.bias, torch.zeros(36))
