"""The port's YOLOv5 and YOLOv10 (``adas_tpu_torch/models/yolo.py``), the v5
and v5-lite decode contracts and the ``YoloDetector`` options against the
JAX package, on the CPU (the other families:
``tests/test_torch_family_checks.py``).

Nets at scale n (v10 also s and m: C2fCIB with and without the
large-kernel RepVGGDW, PSA with one and more heads) on 64-96 px inputs in
f32, through one flax variable tree made from a numpy seed (both heads of
v10 included: its tree is made through ``YoloV10.both``).  Bounds as
``test_torch_models.py``: boxes rtol 1e-3 with an atol of 1e-3 of the
output's largest magnitude, probabilities atol 1e-4.  The calibrated
int8 nets (v5n and v10n at 128x128, JAX's scales carried across, as
``test_torch_int8_models.py``): relative L2 error below 2e-2 per output;
their packer, calibrator and bridge as ``test_torch_int8_weights.py``
holds v8's.

The one-to-one head's top-k: the port sorts stably, as ``lax.top_k``
orders ties, but two frameworks' scores that differ in their last bits
can still swap near-equal rows.  So the rows are compared as sets: every
row whose score clears the k-th score by a margin (1e-4 in f32, 5e-3 in
int8) has a row in the other output with the same class and the same box
(the box bound above), and the sorted scores agree (atol 1e-4 / 5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import yolo as jyolo
from adas_tpu.models.layers import quantized
from adas_tpu.ops.yolo_decode import decode_predictions as jax_decode
from adas_tpu.ops.yolo_decode import select_and_nms as jax_select_and_nms
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu.tools.quantize import calibrate_act_scales
from adas_tpu.utils.types import ObjectModelType as JaxObjectModelType
from adas_tpu_torch.models import yolo
from adas_tpu_torch.ops.yolo_decode import decode_predictions, select_and_nms
from adas_tpu_torch.perception.object_detector import YOLO_OPTIONS, YoloDetector
from adas_tpu_torch.utils.types import ObjectModelType
from adas_tpu_torch.weights import load_flax_variables
from test_torch_models import save_npz


def flax_weights(net, input_shape, seed, **init):
    """``test_torch_models.random_flax_weights`` for any init method of
    ``net`` (``init``: e.g. ``method=net.both``, which makes v10's two
    heads)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda k, x: net.init(k, x, **init), jax.random.PRNGKey(0),
                          jnp.zeros(input_shape))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}::{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                a = rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[:-1])))
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            flat[path] = a.astype(np.float32)

    walk(tree, "")
    return flat


def _tree(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))


def _pair(family, scale, hw, int8=False, max_det=300):
    """The JAX net, its init/apply method keywords, and the port's net of
    the same family, scale and input."""
    if family == "v10":
        jnet = jyolo.YoloV10(jyolo.YoloSpec(family, scale, 80, hw), max_det=max_det)
        net = yolo.YoloV10(yolo.YoloSpec(scale, 80, hw, family=family), int8=int8,
                           max_det=max_det)
        return jnet, dict(method=jnet.both), net
    jnet = jyolo.build_yolo(jyolo.YoloSpec(family, scale, 80, hw))
    return jnet, {}, yolo.build_yolo(yolo.YoloSpec(scale, 80, hw, family=family), int8=int8)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_same_topk(got, want, margin):
    """(B, k, 6) one-to-one rows compared as sets beyond ``margin`` (module
    docstring)."""
    assert got.shape == want.shape
    scale = float(np.abs(want[..., :4]).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.sort(g[:, 4]), np.sort(w[:, 4]), atol=margin)
        kth = w[:, 4].min()
        for a, b in ((w, g), (g, w)):
            for row in a[a[:, 4] > kth + margin]:
                same = (b[:, 5] == row[5]) & np.all(
                    np.abs(b[:, :4] - row[:4]) <= 1e-3 * scale + 1e-3 * np.abs(row[:4]), axis=1)
                assert same.any(), row


@pytest.mark.parametrize("family,scale,hw", [
    ("v5", "n", (64, 96)),
    ("v5", "s", (64, 64)),
    ("v10", "n", (64, 96)),
    ("v10", "s", (64, 64)),  # C2fCIB with RepVGGDW at stride 32, 4 PSA heads
    ("v10", "m", (64, 64)),  # C2fCIB without RepVGGDW, C2fCIB pan4
])
def test_yolo_family_matches_jax(family, scale, hw):
    jnet, call, net = _pair(family, scale, hw, max_det=50)
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    flat = flax_weights(jnet, (1, *hw, 3), seed=3, **call)
    want = jax.jit(lambda v, xx: jnet.apply(v, xx, **call))(_tree(flat), jnp.asarray(x))
    load_flax_variables(net.eval(), flat)
    with torch.no_grad():
        got = net.both(_nchw(x)) if family == "v10" else net(_nchw(x))
    if family == "v10":
        (got, got_o2o), (want, want_o2o) = got, want
        assert_same_topk(got_o2o.numpy(), np.asarray(want_o2o), margin=1e-4)
    got, want = got.numpy(), np.asarray(want)
    n = yolo.YoloSpec(scale, 80, hw).num_anchors
    if family == "v5":
        assert got.shape == want.shape == (2, 3 * n, 85)
        _close(got[..., :4], want[..., :4])  # xywh in pixels
        np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-4)  # obj, class
    else:
        assert got.shape == want.shape == (2, 84, n)
        _close(got[:, :4], want[:, :4])
        np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=1e-4)


def test_yolov10_one2one_matches_jax():
    """``one2one`` alone (the NMS-free serving call) against JAX's."""
    hw = (96, 96)
    jnet, call, net = _pair("v10", "n", hw, max_det=40)
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    flat = flax_weights(jnet, (1, *hw, 3), seed=5, **call)
    want = np.asarray(jax.jit(lambda v, xx: jnet.apply(v, xx, method=jnet.one2one))(
        _tree(flat), jnp.asarray(x)))
    load_flax_variables(net.eval(), flat)
    with torch.no_grad():
        got = net.one2one(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 40, 6)
    assert_same_topk(got, want, margin=1e-4)


def _calibrated(jnet, call, shape, xs, seed):
    flat = flax_weights(jnet, shape, seed, **call)
    cal = calibrate_act_scales(
        lambda v, x: jnet.apply(v, x, mutable=["act_scales"], **call), _tree(flat), xs)
    return cal, flatten_variables(cal)


@pytest.mark.parametrize("family", ["v5", "v10"])
def test_yolo_family_int8_matches_jax(family):
    """Calibrated int8 (JAX's scales): every dense conv W8A8 with s8
    chaining and the concat groups of each family (v5: C3 and the lat5/lat4
    neck; v10: C2fCIB's explicit group quantize, PSA's group-A exit,
    SCDown's quantize into group A), the depthwise convs and v5's 6x6 stem
    in bf16."""
    hw = (128, 128)
    jnet, call, net = _pair(family, "n", hw, int8=True, max_det=50)
    x = np.random.default_rng(6).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    cal, flat = _calibrated(jnet, call, (1, *hw, 3), [jnp.asarray(x[:1]), jnp.asarray(x[1:])],
                            seed=7)
    groups = [k for k in flat if k.endswith(("concat_xmax", "neck_a_xmax", "neck_b_xmax"))]
    assert len(groups) == 11  # the 9 blocks' groups + the two neck groups

    def serve(v, xx):
        with quantized("int8"):
            return jnet.apply(v, xx, **call)
    want = jax.jit(serve)(cal, jnp.asarray(x, jnp.bfloat16))
    load_flax_variables(net, flat)
    net.eval().requires_grad_(False)
    with torch.no_grad():
        xt = _nchw(x, torch.bfloat16)
        got = net.both(xt) if family == "v10" else net(xt)
    if family == "v10":
        (got, got_o2o), (want, want_o2o) = got, want
        assert_same_topk(got_o2o.numpy(), np.asarray(want_o2o, np.float32), margin=5e-3)
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert _rel(got[:, :4], want[:, :4]) < 2e-2  # xywh
        assert _rel(got[:, 4:], want[:, 4:]) < 2e-2  # class probabilities
    else:
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert _rel(got[..., :4], want[..., :4]) < 2e-2
        assert _rel(got[..., 4:], want[..., 4:]) < 2e-2


def test_v5_decode_contract_matches_jax():
    """v5 raw (B, N, 5+nc): confidence = objectness x class probability,
    then the same selection as v8's (``yolo_decode.py:83-95``)."""
    rng = np.random.default_rng(8)
    b, n, nc = 2, 600, 5
    centers = rng.uniform(0, 320, (b, n // 6, 2)).repeat(6, axis=1)
    xy = centers + rng.normal(0, 5, (b, n, 2))
    wh = rng.uniform(10, 60, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.permutation(b * n * nc).reshape(b, n, nc) / (b * n * nc)
    raw = np.concatenate([xy, wh, obj, cls], axis=-1).astype(np.float32)
    boxes, scores, ids = decode_predictions(torch.from_numpy(raw), ObjectModelType.YOLOV5, nc,
                                            (320, 320))
    got = select_and_nms(boxes, scores, ids, 0.2, 0.45, 50).numpy()
    for i in range(b):
        jb, js, ji = jax_decode(jnp.asarray(raw[i]), JaxObjectModelType.YOLOV5, nc, (320, 320))
        np.testing.assert_allclose(scores[i].numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_array_equal(ids[i].numpy(), np.asarray(ji))
        want = np.asarray(jax_select_and_nms(jb, js, ji, box_score=0.2, iou_threshold=0.45,
                                             max_det=50))
        np.testing.assert_array_equal(got[i, :, 5], want[:, 5])
        np.testing.assert_allclose(got[i], want, atol=1e-4)
        assert (want[:, 4] > 0).sum() > 5
    # v5-lite: the rows grid-decoded first (a 32x96 input: 3 anchors x 63 cells)
    lite = np.random.default_rng(9).uniform(0, 1, (b, 3 * (48 + 12 + 3), 5 + nc))
    lite = lite.astype(np.float32)
    gb, gs, gi = decode_predictions(torch.from_numpy(lite), ObjectModelType.YOLOV5_LITE, nc,
                                    (32, 96))
    for i in range(b):
        jb, js, ji = jax_decode(jnp.asarray(lite[i]), JaxObjectModelType.YOLOV5_LITE, nc, (32, 96))
        np.testing.assert_allclose(gb[i].numpy(), np.asarray(jb), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(gs[i].numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_array_equal(gi[i].numpy(), np.asarray(ji))


def test_yolo_options_match_jax():
    """The facade's options and defaults are JAX's by name and value,
    ``onnx_mode`` included; every other family resolves an
    unknown scale as JAX's ``build_yolo`` does (v5-lite s, v6 s, v9 c; v7
    one graph), and the facade builds at that scale as JAX's does
    (``object_detector.py:207-212``)."""
    want = dict(JaxYolo._defaults)
    got = {k: (v.name if k == "model_type" else v) for k, v in YOLO_OPTIONS.items()}
    want["model_type"] = want["model_type"].name
    assert got == want
    assert YoloDetector.check_defaults() is YOLO_OPTIONS
    det = YoloDetector(input_size=(64, 64), device="cpu")
    assert isinstance(det.net, yolo.YoloV5) and det.spec.family == "v5"
    for family, want in (("v5lite", "s"), ("v6", "s"), ("v7", "x"), ("v9", "c")):
        jnet = jyolo.build_yolo(jyolo.YoloSpec(family, "x", 80, (64, 64)))
        jax_scale = getattr(jnet, "variant", jnet.spec.scale)  # GELAN's variant
        spec = yolo.resolve_spec(yolo.YoloSpec("x", 80, (64, 64), family=family))
        assert spec.scale == jax_scale == want
    det = YoloDetector(model_type=ObjectModelType.YOLOV6, scale="x", input_size=(64, 64),
                       device="cpu")  # the facade resolves the scale it builds
    assert det.spec.scale == "s" and type(det.net).__name__ == "YoloV6"


@pytest.mark.parametrize("family,scale,stem", [
    ("v8", "n", 16), ("v10", "s", 32), ("v8", "m", 48), ("v8", "l", 64), ("v10", "x", 80),
    ("v5", "s", 32),
])
def test_every_scale_builds(family, scale, stem):
    """Each ported family builds at every scale; the v8/v10 stems are the
    fused stem's 16-80 features (instantiated in ``csrc/stem.cu``'s
    ``ADAS_STEM_CONFIGS`` list, read here from the source: the library
    needs nvcc), v5's is a plain 6x6/2 conv padded by 2."""
    import re
    from pathlib import Path

    import adas_tpu_torch

    src = (Path(adas_tpu_torch.__file__).parent / "csrc" / "stem.cu").read_text()
    listed = src.split("#define ADAS_STEM_CONFIGS(X)", 1)[1].split("\n\n", 1)[0]
    served = {(int(k), p == "true", int(f))
              for k, p, f in re.findall(r"X\((\d+), (true|false), (\d+)\)", listed)}
    assert (7, True, 64) in served and len(served) == 6
    net = yolo.build_yolo(yolo.YoloSpec(scale, 80, (64, 64), family=family))
    conv = net.net.stem.conv
    assert conv.out_channels == stem
    if family == "v5":
        assert conv.kernel_size == (6, 6) and conv.padding == (2, 2) and not net.net.stem.stem
    else:
        assert net.net.stem.stem and (3, False, stem) in served


@pytest.mark.parametrize("family", ["v5", "v10"])
def test_int8_packer_calibrator_and_bridge_match_jax(family, tmp_path):
    """The int8 facades of ``test_torch_int8_weights.py``'s checks, on v5n
    and v10n (128x128, weights from one ``.npz``): the port's packer packs
    exactly the kernels JAX's does (v10: both heads, as JAX packs through
    ``both``), bit-equal; ``calibrate_int8`` on two BGR frames records the
    same scale keys (the concat groups of C3 and C2fCIB included), each
    within rtol 2e-2 of JAX's; and JAX's calibrated, packed tree loads
    whole into a new port net, every int8 leaf in its buffer."""
    
    from test_torch_int8_weights import _int8_buffers, _jax_leaves

    hw = (128, 128)
    jnet, call, _ = _pair(family, "n", hw)
    path = str(tmp_path / f"{family}.npz")
    save_npz(path, unflatten_variables(flax_weights(jnet, (1, *hw, 3), seed=9, **call)))
    jax_type, port_type = (getattr(t, f"YOLO{family.upper()}")
                           for t in (JaxObjectModelType, ObjectModelType))
    jax_side = JaxYolo(model_path=path, model_type=jax_type, input_size=hw, compute_dtype="int8")
    port = YoloDetector(model_path=path, model_type=port_type, input_size=hw,
                        compute_dtype="int8", device="cpu")
    wscales = _jax_leaves(jax_side.variables, "wscales")
    params = _jax_leaves(jax_side.variables, "params")
    ours = _int8_buffers(port.net)
    packed = {k[: -len(".wscale")] for k in wscales}
    assert packed == {k[: -len(".wq")] for k in ours if k.endswith(".wq")}
    assert (family == "v10") == any(k.startswith("head_o2o.") for k in packed)
    for k in packed:
        kern = np.asarray(params[f"{k}.kernel"])
        np.testing.assert_array_equal(ours[f"{k}.wq"].numpy(), kern.transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(ours[f"{k}.wscale"].numpy(),
                                      np.asarray(wscales[f"{k}.wscale"]).reshape(-1))

    frames = list(np.random.default_rng(3).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8))
    jax_side.calibrate_int8(frames)
    port.calibrate_int8(frames)
    want = _jax_leaves(jax_side.variables, "act_scales")
    got = {k: v for k, v in _int8_buffers(port.net).items()
           if not k.endswith((".wq", ".wscale"))}
    assert set(got) == set(want)
    assert sum(k.endswith("concat_xmax") for k in want) == 9
    for k, v in want.items():
        assert abs(float(got[k]) / float(v) - 1) < 2e-2, k

    net = yolo.build_yolo(port.spec, int8=True)
    load_flax_variables(net, flatten_variables(jax_side.variables))
    bufs = _int8_buffers(net)
    for coll in ("act_scales", "wscales"):
        for k, v in _jax_leaves(jax_side.variables, coll).items():
            np.testing.assert_array_equal(bufs[k].numpy().reshape(-1),
                                          np.asarray(v, np.float32).reshape(-1))
