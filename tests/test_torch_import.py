"""The port's checkpoint importers against the JAX package's, on the CPU.

No released checkpoint ships in the repo, so, as ``tests/test_yolo_import.py``
does, each synthetic state dict is made under the released key names from
a mapping's source keys, with seeded values in the shapes of the JAX
net's tree (``jax.eval_shape`` of its init: nothing is compiled).  Then:

* the port's importer and JAX's give equal flat dicts, to the bit
  (every YOLO family and scale JAX maps; UFLD v1, v2 with and without
  the LayerNorm, CurveLanes, the ResNet-18/34/50 trunks, EfficientDet-D0
  with a 90-way head, and RepVGG's ingest fusion);
* the port's module of the same net takes every leaf through
  ``weights.load_flax_variables`` (built on the meta device: only keys
  and shapes count there) and, for the smallest scales, gives the tree
  back through ``weights.flax_variables`` to the bit;
* the missing-key and leftover errors say what JAX's say;
* the archives round-trip between the packages: ``.onnx`` initializers
  (each package's writer, the other's reader), ``params_io`` ``.npz``
  and the ``_int8.npz`` store;
* ``load_state_dict`` strips ``module.`` and unwraps ``model``, and does
  not unpickle without leave.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import efficientdet as jax_effdet
from adas_tpu.models import resnet as jax_resnet
from adas_tpu.models import ufld as jax_ufld
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import build_yolo as jax_build_yolo
from adas_tpu.tools import efficientdet_import as jax_ei
from adas_tpu.tools import onnx_import as jax_onnx_import
from adas_tpu.tools import onnx_writer as jax_onnx_writer
from adas_tpu.tools import params_io as jax_params_io
from adas_tpu.tools import quantize as jax_quantize
from adas_tpu.tools import torch_import as jax_ti
from adas_tpu.tools import yolo_import as jax_yi
from adas_tpu_torch.models import efficientdet as port_effdet
from adas_tpu_torch.models import resnet as port_resnet
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.yolo import YoloSpec, build_yolo
from adas_tpu_torch.tools import efficientdet_import as ei
from adas_tpu_torch.tools import onnx_import, onnx_writer, params_io, quantize
from adas_tpu_torch.tools import torch_import as ti
from adas_tpu_torch.tools import yolo_import as yi
from adas_tpu_torch.weights import flax_variables, load_flax_variables

#: every (family, scale) JAX's YOLO mapping covers
YOLO_CASES = ([(f, s) for f in ("v5", "v8", "v10") for s in "nsmlx"]
              + [("v6", s) for s in "nsml"] + [("v7", "l"), ("v9", "c")]
              + [("v5lite", s) for s in "esg"])
HW = (64, 64)


def leaf_shapes(net, shape, **kw):
    """{(collection, *path): shape} of a flax net's variables, traced only."""
    tree = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros(shape), **kw))
    return {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def seeded(shape, rng, dst):
    """Seeded values for a leaf; BN variances positive."""
    v = rng.standard_normal(shape, dtype=np.float32)
    return np.abs(v) + 0.5 if dst[-1] == "var" else v


def state_from_mapping(mapping, shapes, seed=0):
    """A torch-named state dict for ``mapping``'s source keys, in the torch
    layout of each destination leaf's shape (``yolo_import._inverse``)."""
    rng = np.random.default_rng(seed)
    return {src: yi._inverse(t)(seeded(shapes[(coll,) + tuple(dst)], rng, dst))
            for src, coll, dst, t in mapping}


def assert_flat_equal(got, want):
    got, want = params_io.flatten_variables(got), jax_params_io.flatten_variables(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    return got


def takes_every_leaf(make, flat):
    """``make()``'s module, built on the meta device, takes every leaf of
    ``flat`` (load_flax_variables checks keys and shapes; the copy itself
    is a no-op there)."""
    with torch.device("meta"):
        net = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        load_flax_variables(net, flat)


def round_trips(make, flat):
    """A CPU module of ``make()`` loads ``flat`` and gives it back to the bit."""
    net = make()
    load_flax_variables(net, flat)
    back = flax_variables(net)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def yolo_specs(family, scale):
    return (YoloSpec(family=family, scale=scale, num_classes=80, input_size=HW),
            JaxYoloSpec(family=family, scale=scale, num_classes=80, input_size=HW))


@functools.lru_cache(maxsize=None)
def yolo_shapes(jspec):
    """The JAX YOLO tree's leaf shapes (v10's through ``both``: both heads),
    traced once per spec in a process."""
    jnet = jax_build_yolo(jspec)
    return leaf_shapes(jnet, (1, *HW, 3), **({"method": jnet.both} if jspec.family == "v10"
                                             else {}))


@pytest.mark.parametrize("family,scale", YOLO_CASES)
def test_yolo_mapping_matches_jax(family, scale):
    spec, jspec = yolo_specs(family, scale)
    shapes = yolo_shapes(jspec)
    state = state_from_mapping(yi.yolo_mapping(spec), shapes)
    # the skipped buffers of each layout are tolerated; an ultralytics
    # export nests the model once more (``model.model.``)
    state["model.model.99.anchors"] = np.ones(3, np.float32)
    flat = assert_flat_equal(yi.yolo_variables(state, spec), jax_yi.yolo_variables(state, jspec))
    assert {k.split("::", 1)[1] for k in flat} == {"::".join(k[1:]) for k in shapes}
    takes_every_leaf(lambda: build_yolo(spec), flat)
    if scale in "ne":
        round_trips(lambda: build_yolo(spec), flat)
    if (family, scale) != ("v5lite", "g"):  # g's export is its deploy form
        del state["model.model.99.anchors"]
        exported = yi.yolo_state_dict(flat, spec)
        assert sorted(exported) == sorted(state)
        assert all(np.array_equal(exported[k], state[k]) for k in state)


@pytest.mark.parametrize("family", ["v8", "v10"])
def test_yolo_errors_match_jax(family):
    spec, jspec = yolo_specs(family, "n")
    for state in ({}, {"model.0.conv.weight": np.zeros((16, 3, 3, 3), np.float32)}):
        with pytest.raises(KeyError) as want:
            jax_yi.yolo_variables(state, jspec)
        with pytest.raises(KeyError) as got:
            yi.yolo_variables(state, spec)
        assert str(got.value) == str(want.value)
    full = state_from_mapping(yi.yolo_mapping(spec), yolo_shapes(jspec))
    full["model.30.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError) as want:
        jax_yi.yolo_variables(full, jspec)
    with pytest.raises(KeyError) as got:
        yi.yolo_variables(full, spec)
    assert "unmapped checkpoint tensors" in str(got.value) and str(got.value) == str(want.value)


def _train_form(state, rng):
    """v5-lite-g's deploy-form ``.fused.*`` blocks as RepVGG's training
    form: a 3x3 conv + BN, a 1x1 conv + BN, and an identity BN where the
    block keeps its width."""
    out = {k: v for k, v in state.items() if ".fused." not in k}
    for key in [k for k in state if k.endswith(".fused.weight")]:
        p = key[: -len(".fused.weight")]
        o, i = state[key].shape[:2]
        out[f"{p}.rbr_dense.conv.weight"] = rng.standard_normal((o, i, 3, 3), dtype=np.float32)
        out[f"{p}.rbr_1x1.conv.weight"] = rng.standard_normal((o, i, 1, 1), dtype=np.float32)
        for bn in ["rbr_dense.bn", "rbr_1x1.bn"] + (["rbr_identity"] if o == i else []):
            out[f"{p}.{bn}.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
            out[f"{p}.{bn}.bias"] = rng.standard_normal(o, dtype=np.float32)
            out[f"{p}.{bn}.running_mean"] = rng.standard_normal(o, dtype=np.float32)
            out[f"{p}.{bn}.running_var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
            out[f"{p}.{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    return out


def test_fuse_repvgg_state_matches_jax():
    """RepVGG's switch_to_deploy at ingest on a v5-lite-g training-form
    dict: the fused tensors, and the tree the importer makes of them."""
    spec, jspec = yolo_specs("v5lite", "g")
    deploy = state_from_mapping(yi.yolo_mapping(spec), yolo_shapes(jspec))
    train = _train_form(deploy, np.random.default_rng(1))
    assert any(".rbr_identity." in k for k in train)
    got, want = yi.fuse_repvgg_state(train), jax_yi.fuse_repvgg_state(train)
    assert sorted(got) == sorted(want) and sorted(got) == sorted(deploy)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flat = assert_flat_equal(yi.yolo_variables(train, spec), jax_yi.yolo_variables(train, jspec))
    takes_every_leaf(lambda: build_yolo(spec), flat)


def _flax_to_torch(shapes, seed, version=2, curvelanes=False):
    """A torch-named UFLD state dict for a flax tree's shapes, with the
    training-only keys a release carries (aux head, BN counters)."""
    rng = np.random.default_rng(seed)
    flat = {"::".join(k): seeded(s, rng, k) for k, s in shapes.items()}
    state = ti.ufld_state_dict(flat, version=version, curvelanes=curvelanes)
    state["model.bn1.num_batches_tracked"] = np.zeros((), np.int64)
    state["seg_head.aux2_0.weight"] = np.zeros((4, 4), np.float32)
    return state


UFLD_V2_SMALL = dict(input_height=64, input_width=160, crop_ratio=0.6, num_cell_row=20,
                     num_row=72, num_cell_col=10, num_col=16, mlp_mid=64)
UFLD_V1_SMALL = dict(input_height=64, input_width=160, griding_num=10, cls_num_per_lane=4,
                     mlp_mid=32)
CURVE_SMALL = dict(input_height=64, input_width=128, crop_ratio=0.8, num_cell_row=10,
                   num_row=8, num_cell_col=6, num_col=5, mlp_mid=32)


@pytest.mark.parametrize("kind", ["v2", "v2_no_norm", "v1", "curvelanes"])
def test_ufld_importers_match_jax(kind):
    if kind == "v1":
        jnet, make = (jax_ufld.UFLDv1Net(jax_ufld.UFLDv1Spec(**UFLD_V1_SMALL)),
                      lambda: port_ufld.UFLDv1Net(port_ufld.UFLDv1Spec(**UFLD_V1_SMALL)))
    else:
        args = dict(CURVE_SMALL if kind == "curvelanes" else UFLD_V2_SMALL,
                    fc_norm=kind != "v2_no_norm")
        jspec, spec = jax_ufld.UFLDv2Spec(**args), port_ufld.UFLDv2Spec(**args)
        if kind == "curvelanes":
            jnet, make = (jax_ufld.UFLDv2CurveLanesNet(jspec),
                          lambda: port_ufld.UFLDv2CurveLanesNet(spec))
        else:
            jnet, make = jax_ufld.UFLDv2Net(jspec), lambda: port_ufld.UFLDv2Net(spec)
    shapes = leaf_shapes(jnet, (1, 64, UFLD_V2_SMALL["input_width"] if kind != "curvelanes"
                                else CURVE_SMALL["input_width"], 3))
    version = 1 if kind == "v1" else 2
    state = _flax_to_torch(shapes, seed=2, version=version, curvelanes=kind == "curvelanes")
    if kind == "curvelanes":
        got, want = ti.ufld_curvelanes_variables(state), jax_ti.ufld_curvelanes_variables(state)
    else:
        fc_norm = kind != "v2_no_norm"
        got = ti.ufld_variables(state, version=version, fc_norm=fc_norm)
        want = jax_ti.ufld_variables(state, version=version, fc_norm=fc_norm)
    flat = assert_flat_equal(got, want)
    round_trips(make, flat)
    with pytest.raises(KeyError) as jerr:
        jax_ti.ufld_variables({"head.x": np.zeros(1)})
    with pytest.raises(KeyError) as perr:
        ti.ufld_variables({"head.x": np.zeros(1)})
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("depth", ["18", "34", "50"])
def test_resnet_variables_match_jax(depth):
    shapes = leaf_shapes(jax_resnet.ResNetFeatures(depth=depth), (1, 64, 64, 3))
    rng = np.random.default_rng(3)
    flat = {"::".join(k): seeded(s, rng, k) for k, s in shapes.items()}
    state = {ti._resnet_name(tuple(k.split("::")[1:])):
             np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v for k, v in flat.items()}
    state["fc.weight"] = np.zeros((10, 512), np.float32)  # the classifier is ignored
    got = assert_flat_equal(ti.resnet_variables(state), jax_ti.resnet_variables(state))
    assert sorted(got) == sorted(flat) and all(np.array_equal(got[k], flat[k]) for k in flat)
    takes_every_leaf(lambda: port_resnet.ResNetFeatures(depth), got)


def test_efficientdet_variables_match_jax():
    """EfficientDet-D0 with zylo117's 90-way head; the lukemelas
    classification tail a release keeps is skipped."""
    jspec = jax_effdet.EfficientDetSpec(compound=0, num_classes=90)
    spec = port_effdet.EfficientDetSpec(compound=0, num_classes=90)
    shapes = leaf_shapes(jax_effdet.EfficientDet(jspec), (1, 128, 128, 3))
    state = state_from_mapping(ei.efficientdet_mapping(spec), shapes, seed=4)
    assert state["classifier.header.pointwise_conv.conv.bias"].size == 90 * 9
    state["backbone_net.model._fc.weight"] = np.zeros((1000, 1280), np.float32)
    state["anchors.last_anchors"] = np.zeros(1, np.float32)
    flat = assert_flat_equal(ei.efficientdet_variables(state, spec),
                             jax_ei.efficientdet_variables(state, jspec))
    takes_every_leaf(lambda: port_effdet.EfficientDet(spec), flat)
    exported = ei.efficientdet_state_dict(flat, spec)
    assert all(np.array_equal(exported[k], state[k]) for k in exported)
    state["bifpn.0.extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError) as jerr:
        jax_ei.efficientdet_variables(state, jspec)
    with pytest.raises(KeyError) as perr:
        ei.efficientdet_variables(state, spec)
    assert str(perr.value) == str(jerr.value)


ONNX_TENSORS = {
    "model.0.conv.weight": np.random.default_rng(5).standard_normal((16, 3, 3, 3)).astype(np.float32),
    "half": np.arange(6, dtype=np.float16).reshape(2, 3),
    "s8": np.array([-127, 0, 5, 127], np.int8),
    "ids": np.array([-(2 ** 40), 3], np.int64),
    "scalar": np.array(2.5, np.float64),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_onnx_initializers_round_trip(tmp_path, writer):
    """An ``.onnx`` of initializers from either package's writer reads the
    same in both readers, to the bit."""
    w = onnx_writer if writer == "port" else jax_onnx_writer
    path = str(tmp_path / "init.onnx")
    w.save_model(path, w.simple_model([], [], [], initializers=ONNX_TENSORS))
    got = onnx_import.read_onnx_initializers(path)
    want = jax_onnx_import.read_onnx_initializers(path)
    assert sorted(got) == sorted(want) == sorted(ONNX_TENSORS)
    for k, v in ONNX_TENSORS.items():
        for arr in (got[k], want[k]):
            assert arr.dtype == v.dtype and arr.shape == v.shape
            np.testing.assert_array_equal(arr, v)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"conv": {"kernel": rng.standard_normal((3, 3, 16, 32)).astype(np.float32),
                                "bias": rng.standard_normal(32).astype(np.float32)},
                       "zero": {"kernel": np.zeros((64, 32), np.float32)}},
            "batch_stats": {"bn": {"var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}},
            "act_scales": {"conv": {"xmax": np.float32(3.5)}}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_and_int8_stores_round_trip(tmp_path, writer):
    """``save_params``/``load_params`` and ``save_int8``/``load_int8``: a file
    either package writes reads to the bit in the other, and the int8
    quantization itself is JAX's, to the bit."""
    tree = _tree(6)
    mods = (params_io, quantize) if writer == "port" else (jax_params_io, jax_quantize)
    mods[0].save_params(str(tmp_path / "w.npz"), tree)
    mods[1].save_int8(str(tmp_path / "w_int8.npz"), tree)
    for p_io, q in ((params_io, quantize), (jax_params_io, jax_quantize)):
        assert_flat_equal(p_io.load_params(str(tmp_path / "w.npz")), tree)
        assert_flat_equal(q.load_int8(str(tmp_path / "w_int8.npz")),
                          jax_quantize.load_int8(str(tmp_path / "w_int8.npz")))
    q, s = quantize.quantize_int8(tree)
    jq, js = jax_quantize.quantize_int8(tree)
    for got, want in ((q, jq), (s, js)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert sorted(s) == ["params::conv::kernel", "params::zero::kernel"]


@pytest.mark.parametrize("mode", ["fp16", "bf16", "fp32"])
def test_cast_params_matches_jax(tmp_path, mode):
    """The casts, written by the port, are the bytes JAX writes; a bf16
    leaf (raw ``|V2`` in an ``.npz``) loads into a port module as bf16, and
    a bf16 module's ``flax_variables`` gives the same bits back."""
    tree = _tree(7)
    params_io.save_params(str(tmp_path / "port.npz"), quantize.cast_params(tree, mode))
    jax_params_io.save_params(str(tmp_path / "jax.npz"), jax_quantize.cast_params(tree, mode))
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    if mode == "bf16":
        conv = torch.nn.Conv2d(16, 32, 3)
        cast = quantize.cast_params(tree, mode)["params"]["conv"]
        load_flax_variables(conv, {f"params::{k}": v for k, v in cast.items()})
        want = torch.from_numpy(tree["params"]["conv"]["kernel"]).permute(3, 2, 0, 1)
        assert torch.equal(conv.weight, want.to(torch.bfloat16).float())
        # and a bf16 module writes the same bits back
        back = flax_variables(conv.to(torch.bfloat16))
        assert all(back[f"params::{k}"].tobytes() == v.tobytes() for k, v in cast.items())


def test_load_state_dict_prefixes_and_pickle_gate(tmp_path, monkeypatch):
    """``module.`` is stripped and a ``{"model": ...}`` wrapper unwrapped, as
    JAX does; a ``model.model.`` YOLO layout imports; a checkpoint that
    needs unpickling is refused without ``allow_pickle`` or
    ``ADAS_TORCH_UNPICKLE=1``."""
    spec, jspec = yolo_specs("v8", "n")
    state = state_from_mapping(yi.yolo_mapping(spec), yolo_shapes(jspec))
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {"module.model." + k: torch.from_numpy(v) for k, v in state.items()}},
               path)
    got, want = ti.load_state_dict(path), jax_ti.load_state_dict(path)
    assert sorted(got) == sorted(want) == sorted("model." + k for k in state)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert_flat_equal(yi.yolo_variables(got, spec), jax_yi.yolo_variables(want, jspec))

    conv = torch.nn.Conv2d(3, 4, 1)
    torch.save({"model": conv}, path)  # a whole module: needs unpickling
    monkeypatch.delenv("ADAS_TORCH_UNPICKLE", raising=False)
    with pytest.raises(ValueError, match="allow_pickle"):
        ti.load_state_dict(path)
    assert sorted(ti.load_state_dict(path, allow_pickle=True)) == ["bias", "weight"]
    monkeypatch.setenv("ADAS_TORCH_UNPICKLE", "1")
    np.testing.assert_array_equal(ti.load_state_dict(path)["weight"], conv.weight.detach().numpy())
