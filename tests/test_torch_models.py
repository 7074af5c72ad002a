"""Port's nets (adas_tpu_torch/models) against the flax nets on the same
weights, through the weight bridge (adas_tpu_torch/weights.py).

Small sizes: ResNet-18 + UFLDv2 head on a 64x160 input with shrunken cell
counts and MLP (``num_row`` stays 72 — ``UFLDv2Spec.row_anchor`` returns
CULane's 72 anchors for any other count), and YOLOv8 at scale ``n`` on a
64x96 input.  The flax BatchNorm statistics and affines are random (numpy
seed), so the port's BN and the stem's BN fold are exercised.  The JAX side runs
its plain NHWC path (polyphase stems), the port its NCHW nets with the
stem's plain CPU version.  f32; tolerance rtol 1e-3 with an atol of 1e-3
of the output's largest magnitude (summation order differs between the
two frameworks' convolutions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.models.yolo import YoloSpec, YoloV8
from adas_tpu_torch.weights import init_params, load_flax_variables, state_dict_from_flax

def save_npz(path, variables):
    """``params_io.save_params`` without the compression: the same flat
    ``::`` keys, which both packages' loaders read (``np.load``).  The
    tests' random trees do not compress, and zlib took ~25 s on one full
    UFLDv2 head."""
    np.savez(path, **flatten_variables(variables))


# One intra-op thread per test process: the suite runs in several
# pytest-xdist workers, each of which imports this module while it
# collects, and torch's default (an OpenMP thread per core in every
# worker) oversubscribes the cores several times over; the waiting
# threads then cost more than the parallel kernels gain.
torch.set_num_threads(1)

SPEC_ARGS = dict(
    input_height=64, input_width=160, crop_ratio=0.6, num_cell_row=20,
    num_row=72, num_cell_col=10, num_col=16, mlp_mid=64,
)


def random_flax_weights(net, input_shape, seed):
    """A flat ``::``-keyed numpy variable dict for flax ``net`` (the
    ``params_io`` format), filled from a numpy seed instead of flax's init:
    kernels normal with fan-in variance, BN/LN scales and BN variances in
    [0.5, 1.5], biases and BN means small normals, so every BN fold and
    affine is exercised."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros(input_shape))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}::{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            leaf, shape = k, tuple(v.shape)
            if leaf == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.standard_normal(shape) / np.sqrt(fan_in)
            elif leaf in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            flat[path] = a.astype(np.float32)

    walk(tree, "")
    return flat


def _unflatten(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


def test_ufld_v2_resnet18_matches_jax():
    jnet = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS))
    x = np.random.default_rng(0).standard_normal((2, 64, 160, 3)).astype(np.float32)
    flat = random_flax_weights(jnet, (1, 64, 160, 3), seed=1)
    want = jax.jit(jnet.apply)(_unflatten(flat), jnp.asarray(x))

    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS)).eval()
    load_flax_variables(net, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _close(got[k].numpy(), np.asarray(want[k]))


def test_yolov8n_matches_jax():
    hw = (64, 96)
    jnet = JaxYoloV8(JaxYoloSpec("v8", "n", 80, hw))
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    flat = random_flax_weights(jnet, (1, *hw, 3), seed=3)
    want = np.asarray(jax.jit(jnet.apply)(_unflatten(flat), jnp.asarray(x)))

    net = YoloV8(YoloSpec("n", 80, hw)).eval()
    load_flax_variables(net, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, 84, YoloSpec("n", 80, hw).num_anchors)
    _close(got[:, :4], want[:, :4])  # xywh in pixels
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=1e-4)  # class probs


def test_bridge_rejects_mismatched_trees():
    flat = random_flax_weights(JaxYoloV8(JaxYoloSpec("v8", "n", 80, (64, 64))), (1, 64, 64, 3), 0)
    net = YoloV8(YoloSpec("n", 80, (64, 64)))
    missing = dict(flat)
    missing.pop("params::head::cls2_2::bias")
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(net, missing)
    with pytest.raises(KeyError, match="counterpart"):
        state_dict_from_flax({"act_scales::net::stem::zmax": np.ones(())})
    wrong = dict(flat)
    wrong["params::net::stem::conv::kernel"] = np.zeros((3, 3, 3, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(net, wrong)


def test_seeded_init_mirrors_flax_initializers():
    """lecun_normal: truncated to 2 sigma, fan-in variance; BN at
    identity; biases zero; the same seed gives the same weights."""
    a, b = YoloV8(YoloSpec("n", 80, (64, 64))), YoloV8(YoloSpec("n", 80, (64, 64)))
    init_params(a, seed=7)
    init_params(b, seed=7)
    for (_, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb)
    conv = a.net.sppf.cv2.conv  # 1x1, fan-in 512, 131k samples
    w = conv.weight
    std = (1.0 / conv.in_channels) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() / std - 1) < 0.05
    bn = a.net.sppf.cv2.bn
    assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
    assert torch.all(bn.running_mean == 0) and torch.all(bn.running_var == 1)
    assert torch.all(a.head.box0_2.bias == 0)
