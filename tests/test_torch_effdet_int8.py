"""The port's int8 EfficientDet (``models/efficientdet.py`` with
``int8=True``, ``EfficientdetDetector(compute_dtype="int8")``) against the
JAX package's ``quantized("int8")`` graph and facade, on the CPU.

D0 at 128x128 on one random tree (``test_torch_efficientdet.random_tree``)
behind both int8 facades.  The packer and the calibrator as
``test_torch_int8_weights``: the port packs exactly the kernels JAX packs
(every one a 1x1 at stride 1), bit-equal; the two ``calibrate_int8`` on
two BGR frames record the same keys within rtol 2e-2; JAX's calibrated
tree loads whole into a port net, whose trunk (C3, C4, C5) and boxes and
class probabilities are within relative L2 2e-2 of JAX's int8 net's on a
third frame.  The tree is the unscaled one: with the f32 test's 1.5x
trunk gain (``live_trunk``) the int8 trunk is chaotic, and JAX's own
jitted and eager int8 runs are 10% (boxes) apart; unscaled they agree
within 1.2e-3 and the port within 1.3e-3 of both (on the CPU, jax 0.9.0, torch 2.13.0).  D1-D7
build in int8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import efficientdet as J
from adas_tpu.models.layers import quantized
from adas_tpu.perception.efficientdet_detector import EfficientdetDetector as JaxEffdet
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu_torch.models import efficientdet as P
from adas_tpu_torch.models.quant import QConv2d
from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
from adas_tpu_torch.weights import load_flax_variables
from test_torch_efficientdet import random_tree
from test_torch_int8_weights import _int8_buffers, _jax_leaves
from test_torch_models import save_npz

S = 128


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_effdet_int8_matches_jax(tmp_path):
    """The int8 facades on one ``.npz``: packer, calibrator, bridge, then
    the JAX facade's calibrated tree in a port net against JAX's int8 net
    (and trunk) on a letterboxed, normalized frame."""
    from adas_tpu.ops.preprocess import LetterboxGeometry as JaxGeometry
    from adas_tpu.ops.preprocess import imagenet_preprocess as jax_imagenet_preprocess

    jnet = J.EfficientDet(J.EfficientDetSpec(0, 80, input_size_override=S))
    path = str(tmp_path / "effdet.npz")
    save_npz(path, unflatten_variables(random_tree(jnet, (jnp.zeros((1, S, S, 3)),), 4)))
    jax_side = JaxEffdet(model_path=path, compound=0, input_size=S, compute_dtype="int8")
    port = EfficientdetDetector(model_path=path, compound=0, input_size=S, compute_dtype="int8",
                                device="cpu")
    wscales = _jax_leaves(jax_side.variables, "wscales")
    params = _jax_leaves(jax_side.variables, "params")
    ours = _int8_buffers(port.net)
    packed = {k[: -len(".wscale")] for k in wscales}
    assert packed == {k[: -len(".wq")] for k in ours if k.endswith(".wq")}
    convs = [m for m in port.net.modules() if isinstance(m, QConv2d)]
    assert len(convs) == len(packed) == 67  # expand 15, project 16, laterals 6, separable pw 30
    assert all(m.kernel_size == (1, 1) and m.stride == (1, 1) and m.padding == (0, 0)
               for m in convs)
    for k in packed:
        np.testing.assert_array_equal(ours[f"{k}.wq"].numpy(),
                                      np.asarray(params[f"{k}.kernel"]).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(ours[f"{k}.wscale"].numpy(),
                                      np.asarray(wscales[f"{k}.wscale"]).reshape(-1))
    frames = list(np.random.default_rng(3).integers(0, 256, (3, 90, 160, 3), dtype=np.uint8))
    jax_side.calibrate_int8(frames[:2])
    port.calibrate_int8(frames[:2])
    want = _jax_leaves(jax_side.variables, "act_scales")
    got = {k: v for k, v in _int8_buffers(port.net).items() if not k.endswith((".wq", ".wscale"))}
    assert set(got) == set(want) and len(want) == 67
    for k, v in want.items():
        assert abs(float(got[k]) / float(v) - 1) < 2e-2, k
    cal = jax_side.variables
    net = P.EfficientDet(port.spec, int8=True)
    load_flax_variables(net, flatten_variables(cal))
    bufs = _int8_buffers(net)
    for coll in ("act_scales", "wscales"):
        for k, v in _jax_leaves(cal, coll).items():
            np.testing.assert_array_equal(bufs[k].numpy().reshape(-1),
                                          np.asarray(v, np.float32).reshape(-1))

    def serve(v, xx):
        with quantized("int8"):
            return jnet.apply(v, xx)

    def trunk(v, xx):
        with quantized("int8"):
            return J.EfficientNetFeatures(1.0, 1.0).apply({k: v[k]["backbone"] for k in v}, xx)
    x = jax_imagenet_preprocess(jnp.asarray(frames[2])[None], JaxGeometry(90, 160, S, S))
    want_boxes, want_probs = jax.jit(serve)(cal, x)
    want_feats = jax.jit(trunk)(cal, x)
    net.eval().requires_grad_(False)
    xt = torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        boxes, probs = net(xt)
        feats = net.backbone(xt)
    for got_f, want_f in zip(feats, want_feats):
        got_f = got_f.float().permute(0, 2, 3, 1).numpy()
        assert _rel(got_f, np.asarray(want_f, np.float32)) < 2e-2
    assert boxes.dtype == probs.dtype == torch.float32
    assert _rel(boxes.numpy(), np.asarray(want_boxes)) < 2e-2
    assert _rel(probs.numpy(), np.asarray(want_probs)) < 2e-2


@pytest.mark.parametrize("compound", range(8))
def test_effdet_int8_builds(compound):
    """D0-D7 build in int8: every int8 conv a 1x1 at stride 1 (TF-SAME
    padding zero), the depthwise convs and the stem in bf16, the headers
    f32."""
    net = P.EfficientDet(P.EfficientDetSpec(compound, 90), int8=True)
    convs = [m for m in net.modules() if isinstance(m, QConv2d)]
    assert convs and all(m.kernel_size == (1, 1) and m.stride == (1, 1) for m in convs)
    assert not isinstance(net.regressor.header.pw, QConv2d)
    assert not isinstance(net.backbone.stem_conv, QConv2d)


def test_effdet_compute_dtypes():
    with pytest.raises(ValueError, match="compute_dtype"):
        EfficientdetDetector(compound=0, input_size=S, compute_dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="requires compute_dtype='int8'"):
        EfficientdetDetector(compound=0, input_size=S, device="cpu").calibrate_int8([])
    with pytest.raises(ValueError, match="1x1 at stride 1"):
        P._same_conv(16, 16, 3, int8=True)
