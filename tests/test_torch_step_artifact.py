"""``MultiStreamADAS.export_fused`` / ``step_artifact=``: the whole
multi-stream device step as one ``.adas`` file, against the port's native
step and the JAX package's step artifact of the same configuration.

Two streams of 180x320 frames, YOLOv8n at 160x160 and UFLDv2 on the
reduced CULane spec (``test_torch_slice``'s weights and nets), on the bgr
and the I420 transport; the JAX stems run their XLA chain.  One JAX export
per transport is shared by the module.

* The served pipeline's packed tick equals the native one to the bit, and
  so do its per-stream signals.
* It equals JAX's served pipeline within ``test_torch_slice``'s f32
  bounds (``test_torch_multistream_bgr._assert_f32_ticks_match``).
* ``meta.json`` equals JAX's (both exported for the CPU) in every key.
* A calibrated int8 pipeline's program holds one ``int8_conv`` node per
  int8 conv of both nets, and serves the native bits.
* Refusals: another stream count, ``dev_hw`` or transport; an artifact
  that is not a pipeline's; the compute probe and ``export_fused`` on an
  artifact-served pipeline.
"""
import json
import zipfile

import pytest
import torch

from adas_tpu.models.ufld import UFLDV2_SPECS as JAX_UFLD_SPECS
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.pipeline.multistream import MultiStreamADAS as JaxMultiStream
from adas_tpu_torch.engine.artifact import read_meta
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.quant import QConv2d
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.utils.types import ObjectModelType
from test_torch_artifact import int8_conv_nodes
from test_torch_models import SPEC_ARGS
from test_torch_multistream_bgr import _assert_f32_ticks_match, _jax_pair, _port_pair
from test_torch_slice import CULANE, FRAME_HW, YOLO_HW, _ticks, npz_paths

__all__ = ["npz_paths"]  # the slice tests' weights

TRANSPORTS = ("bgr", "i420")


@pytest.fixture(scope="module")
def served(npz_paths, tmp_path_factory):
    """Per transport: the port's native pipeline, its artifact-served one
    and JAX's artifact-served one, and both files."""
    tmp = tmp_path_factory.mktemp("step_artifacts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
        mp.setitem(JAX_UFLD_SPECS, CULANE, JaxUFLDv2Spec(**SPEC_ARGS))
        mp.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                   port_ufld.UFLDv2Spec(**SPEC_ARGS))
        out = {}
        jyolo, jlane = _jax_pair(npz_paths)
        yolo, lane = _port_pair(npz_paths)
        for transport in TRANSPORTS:
            path, jpath = str(tmp / f"{transport}.adas"), str(tmp / f"jax_{transport}.adas")
            native = MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport=transport)
            native.export_fused(path)
            JaxMultiStream(jyolo, jlane, 2, FRAME_HW, transport=transport).export_fused(
                jpath, platforms=["cpu"])
            out[transport] = dict(
                native=native, path=path, jpath=jpath,
                port=lambda t=transport, p=path: MultiStreamADAS(
                    yolo, lane, 2, FRAME_HW, transport=t, step_artifact=p),
                jax=lambda t=transport, p=jpath: JaxMultiStream(
                    jyolo, jlane, 2, FRAME_HW, transport=t, step_artifact=p),
            )
        yield out
        for v in out.values():
            v["native"].close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_step_artifact_equals_native(served, transport):
    case = served[transport]
    native, ms = case["native"], case["port"]()
    for frames in _ticks(2, seed=1):
        a, b = native.submit(frames), ms.submit(frames)
        assert torch.equal(a, b)
        for want, got in zip(native.fetch(a, frames), ms.fetch(b, frames)):
            assert [(o.label, o.conf, o.tolist()) for o in got["objects"]] == \
                [(o.label, o.conf, o.tolist()) for o in want["objects"]]
            assert got["lanes_status"] == want["lanes_status"]
            assert [list(p) for p in got["lanes_points"]] == \
                [list(p) for p in want["lanes_points"]]
    ms.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_step_artifact_close_to_jax(served, transport):
    _assert_f32_ticks_match(served[transport]["jax"](), served[transport]["port"]())


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_meta_matches_jax(served, transport):
    case = served[transport]
    assert read_meta(case["path"]) == read_meta(case["jpath"])
    with zipfile.ZipFile(case["path"]) as zf:
        assert sorted(zf.namelist()) == ["meta.json", "program.pt2"]


def test_int8_step_artifact(npz_paths, tmp_path, monkeypatch):
    """Calibrated int8 nets on I420: one ``int8_conv`` node per int8 conv of
    the two nets, and the native tick to the bit."""
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        port_ufld.UFLDv2Spec(**SPEC_ARGS))
    yolo = YoloDetector(model_path=npz_paths["yolo"], model_type=ObjectModelType.YOLOV8,
                        scale="n", input_size=YOLO_HW, box_score=0.25, compute_dtype="int8",
                        device="cpu")
    lane = UltrafastLaneDetectorV2(model_path=npz_paths["lane"], compute_dtype="int8",
                                   device="cpu")
    frames = _ticks(1, seed=5)[0]
    yolo.calibrate_int8(frames)
    lane.calibrate_int8(frames)
    native = MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport="i420")
    path = str(tmp_path / "int8.adas")
    meta = native.export_fused(path)
    assert meta["kind"] == "multistream" and meta["platforms"] == ["cpu"]
    n_convs = sum(isinstance(m, QConv2d) for net in (yolo.net, lane.net) for m in net.modules())
    assert int8_conv_nodes(path) == n_convs
    ms = MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport="i420", step_artifact=path)
    for frames in _ticks(2, seed=2):
        assert torch.equal(native.submit(frames), ms.submit(frames))
    native.close()
    ms.close()


def test_refusals(served, npz_paths, tmp_path):
    case = served["i420"]
    yolo, lane = case["native"].yolo, case["native"].lane
    for kw in (dict(n=3), dict(host_downscale=(90, 160)), dict(transport="bgr")):
        n = kw.pop("n", 2)
        kw.setdefault("transport", "i420")
        with pytest.raises(ValueError, match="artifact was built for"):
            MultiStreamADAS(yolo, lane, n, FRAME_HW, step_artifact=case["path"], **kw)
    single = str(tmp_path / "yolo.adas")
    yolo.export_fused(single, (90, 160))
    with pytest.raises(ValueError, match="not a multistream artifact"):
        MultiStreamADAS(yolo, lane, 2, FRAME_HW, transport="i420", step_artifact=single)
    ms = case["port"]()
    with pytest.raises(RuntimeError, match="native graph"):
        ms.make_compute_probe(2)
    with pytest.raises(ValueError, match="native step"):
        ms.export_fused(str(tmp_path / "again.adas"))
    assert json.loads(zipfile.ZipFile(case["path"]).read("meta.json"))["transport"] == "i420"
