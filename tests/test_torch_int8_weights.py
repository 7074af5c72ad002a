"""The port's int8 weight packer, calibrator and weight bridge against
the JAX package, on one random YOLOv8n (160x160) and one small UFLDv2
(ResNet-18, the reduced CULane spec of ``test_torch_models``).

* Packer: ``quant.pack_int8_weights`` (which finds the int8 kernels from
  the port's own module tree) packs exactly the kernels
  ``tools/quantize.pack_int8_weights`` packs (which finds them by
  tracing), with bit-equal s8 kernels and equal weight scales.
* Carrying: a calibrated, packed JAX tree loads into the port with no
  missing or extra key, and every int8 leaf lands in its buffer.
* Writing back: ``weights.flax_variables`` of a port net loaded from
  JAX's calibrated, packed tree is that tree, to the bit.
* Calibrator: ``calibrate_int8`` of the port's facades against the JAX
  facades' on the same two BGR frames and the same weights: the same set
  of scale keys, every leaf within rtol 2e-2 but one.  The two stems round
  differently in bf16 (``test_torch_int8_models``), which moved the
  recorded absmaxes by at most 1.3% here, except ``cls_fc1.xmax`` (2.5%):
  the absmax of a LayerNorm output is one extreme element of a
  normalized vector, the most sensitive leaf; it takes rtol 3e-2.
"""
import numpy as np
import pytest
import torch

from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.perception.lane_detector import UltrafastLaneDetectorV2 as JaxLane
from adas_tpu.perception.object_detector import YoloDetector as JaxYolo
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu.utils.types import LaneModelType, ObjectModelType
from adas_tpu_torch.utils.types import ObjectModelType as PortObjectModelType
from adas_tpu_torch.models import quant as Q
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.weights import flax_variables, load_flax_variables
from test_torch_models import SPEC_ARGS, random_flax_weights, save_npz

HW = (160, 160)
CULANE = LaneModelType.UFLDV2_CULANE


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_weights")
    paths = {}
    for name, net, shape in (
        ("yolo", JaxYoloV8(JaxYoloSpec("v8", "n", 80, HW)), (1, *HW, 3)),
        ("lane", JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS)), (1, 64, 160, 3)),
    ):
        paths[name] = str(tmp / f"{name}.npz")
        save_npz(paths[name], unflatten_variables(random_flax_weights(net, shape, 11)))
    return paths


@pytest.fixture(scope="module")
def facades(npz):
    """JAX and port facades, int8, on the same weights (shared by the
    module's tests, in file order: packing is checked before the
    calibrations)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(
            port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
            port_ufld.UFLDv2Spec(**SPEC_ARGS),
        )
        jyolo = JaxYolo(model_path=npz["yolo"], model_type=ObjectModelType.YOLOV8, scale="n",
                        input_size=HW, compute_dtype="int8")
        jlane = JaxLane(model_path=npz["lane"], model_type=CULANE, dtype="int8")
        yolo = YoloDetector(model_path=npz["yolo"], model_type=PortObjectModelType.YOLOV8,
                            scale="n", input_size=HW, compute_dtype="int8", device="cpu")
        lane = UltrafastLaneDetectorV2(model_path=npz["lane"], compute_dtype="int8", device="cpu")
        yield (jyolo, yolo), (jlane, lane)


def _int8_buffers(net):
    """{flax-style path: tensor} of every set int8 buffer of a port net."""
    out = {}
    for prefix, m in net.named_modules():
        for name, buf in m._buffers.items():
            if name in Q.QUANT_BUFFERS and buf is not None:
                out[f"{prefix}.{name}" if prefix else name] = buf
    return out


def _jax_leaves(variables, coll):
    return {
        k.split("::", 1)[1].replace("::", "."): v
        for k, v in flatten_variables({coll: variables[coll]}).items()
    }


def test_packer_matches_jax(facades):
    for jax_side, port in facades:
        jvars = jax_side.variables
        wscales = _jax_leaves(jvars, "wscales")
        params = _jax_leaves(jvars, "params")
        ours = _int8_buffers(port.net)
        packed = {k[: -len(".wscale")] for k in wscales}
        assert packed == {k[: -len(".wq")] for k in ours if k.endswith(".wq")}
        for path in packed:
            kern = np.asarray(params[f"{path}.kernel"])
            assert kern.dtype == np.int8
            want = kern.transpose(3, 0, 1, 2) if kern.ndim == 4 else kern.T
            np.testing.assert_array_equal(ours[f"{path}.wq"].numpy(), want)
            np.testing.assert_array_equal(ours[f"{path}.wscale"].numpy(),
                                          np.asarray(wscales[f"{path}.wscale"]).reshape(-1))


def test_calibrator_matches_jax(facades):
    frames = np.random.default_rng(3).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
    worst = 0.0
    for jax_side, port in facades:
        jax_side.calibrate_int8(list(frames))
        port.calibrate_int8(list(frames))
        want = _jax_leaves(jax_side.variables, "act_scales")
        got = {k: v for k, v in _int8_buffers(port.net).items()
               if not k.endswith((".wq", ".wscale"))}
        assert set(got) == set(want)
        for k, v in want.items():
            dev = abs(float(got[k]) / float(v) - 1)
            assert dev < (3e-2 if k == "cls_fc1.xmax" else 2e-2), (k, dev)
            worst = max(worst, dev)
    print(f"largest relative deviation of a calibrated scale: {worst:.3g}")


def test_calibrated_packed_tree_loads_whole(facades):
    """JAX's calibrated, packed trees carried into fresh port nets: no
    missing or extra key (load_flax_variables raises on either), every
    int8 leaf in its buffer, the f32 weight the dequantized kernel."""
    frames = np.random.default_rng(4).integers(0, 256, (2, 180, 320, 3), dtype=np.uint8)
    for jax_side, port in facades:
        jax_side.calibrate_int8(list(frames))
        flat = flatten_variables(jax_side.variables)
        net = type(port.net)(port.net.spec, int8=True)
        load_flax_variables(net, flat)
        bufs = _int8_buffers(net)
        for coll in ("act_scales", "wscales"):
            for k, v in _jax_leaves(jax_side.variables, coll).items():
                np.testing.assert_array_equal(bufs[k].numpy().reshape(-1),
                                              np.asarray(v, np.float32).reshape(-1))
        params = _jax_leaves(jax_side.variables, "params")
        for k in (k for k in bufs if k.endswith(".wq")):
            mod = net.get_submodule(k[: -len(".wq")])
            kern = np.asarray(params[k[: -len(".wq")] + ".kernel"])
            assert kern.dtype == np.int8
            deq = torch.from_numpy(kern.astype(np.float32)) * mod.wscale
            want = deq.permute(3, 2, 0, 1) if kern.ndim == 4 else deq.T
            assert torch.equal(mod.weight, want)
        # a second load of an f32 tree clears the int8 buffers again
        load_flax_variables(net, {k: v for k, v in flatten_variables(
            {c: jax_side.variables[c] for c in ("batch_stats",)}).items()} | {
            k: np.asarray(v, np.float32) for k, v in
            flatten_variables({"params": jax_side.variables["params"]}).items()})
        assert not _int8_buffers(net)


def test_flax_variables_gives_back_the_jax_tree(facades):
    """The calibrated, packed JAX trees (of the calibrations above) through
    a fresh port net and back: every leaf of every collection (s8 kernels,
    wscales, act_scales, params, batch_stats) equal, dtype and shape
    included."""
    for jax_side, port in facades:
        want = flatten_variables(jax_side.variables)
        assert any(k.startswith("act_scales::") for k in want)
        net = type(port.net)(port.net.spec, int8=True)
        load_flax_variables(net, want)
        got = flax_variables(net)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
