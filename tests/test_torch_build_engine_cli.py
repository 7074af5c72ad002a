"""``python -m adas_tpu_torch.tools.build_engine`` in its three modes, on
the CPU (``--platforms cpu``).

* Net mode: YOLOv8n at 64x64 from a ``params_io`` ``.npz`` through both
  packages' CLIs; the same printed description, ``meta.json`` equal to
  JAX's, and the served outputs within 1e-4 of JAX's artifact on the same
  NCHW input.
* ``--fused``: UFLDv2 on the reduced CULane spec (``test_torch_slice``'s
  weights); served through ``DetectFrame``, the native lanes to the bit.
* ``--multistream 2``: YOLOv8n at 160 + that UFLDv2, 180x320 frames
  downscaled on the host to 88x160, I420 (JAX's ``test_cli.py:110-135``
  configuration); JAX's printed description, and served through
  ``MultiStreamADAS(step_artifact=...)`` the native tick to the bit.
"""
import sys

import numpy as np
import pytest
import torch

from adas_tpu.engine.artifact import CompiledEngine as JaxCompiledEngine
from adas_tpu.models.yolo import YoloSpec as JaxYoloSpec
from adas_tpu.models.yolo import YoloV8 as JaxYoloV8
from adas_tpu.tools import build_engine as jax_cli
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu_torch.engine.artifact import CompiledEngine, read_meta
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
from adas_tpu_torch.tools import build_engine
from test_torch_models import SPEC_ARGS, random_flax_weights, save_npz
from test_torch_multistream_bgr import _port_pair
from test_torch_slice import FRAME_HW, _ticks, npz_paths

__all__ = ["npz_paths"]  # the slice tests' weights


@pytest.fixture
def reduced_culane(monkeypatch):
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        port_ufld.UFLDv2Spec(**SPEC_ARGS))


def test_net_mode_matches_jax(tmp_path, monkeypatch, capsys):
    npz = str(tmp_path / "y8n64.npz")
    net = JaxYoloV8(JaxYoloSpec("v8", "n", 80, (64, 64)))
    save_npz(npz, unflatten_variables(random_flax_weights(net, (1, 64, 64, 3), seed=2)))
    argv = ["-t", "YOLOV8", "--scale", "n", "--height", "64", "--width", "64", "-w", npz,
            "--platforms", "cpu"]
    out, jout = str(tmp_path / "y8.adas"), str(tmp_path / "jax_y8.adas")
    build_engine.main(argv + ["-o", out])
    printed = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["prog"] + argv + ["-o", jout])
    jax_cli.main()
    assert printed.replace(out, "OUT") == capsys.readouterr().out.replace(jout, "OUT")
    assert "input  [1, 3, 64, 64] float32" in printed
    assert read_meta(out) == read_meta(jout)
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    got = CompiledEngine(out).engine_inference(x)
    want = JaxCompiledEngine(jout).engine_inference(x)
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape == (1, 84, 84)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * np.abs(want[0]).max())


def test_fused_mode(npz_paths, reduced_culane, tmp_path, capsys):
    out = str(tmp_path / "lane.adas")
    build_engine.main(["-t", "UFLDV2_CULANE", "-w", npz_paths["lane"], "-o", out, "--fused",
                       "--frame-height", "180", "--frame-width", "320", "--platforms", "cpu"])
    printed = capsys.readouterr().out
    assert "=== fused engine" in printed and "frame  [180, 320, 3] uint8" in printed
    native = UltrafastLaneDetectorV2(model_path=npz_paths["lane"], device="cpu")
    served = UltrafastLaneDetectorV2(model_path=out, device="cpu")
    for frame in _ticks(1, seed=3)[0]:
        native.DetectFrame(frame)
        served.DetectFrame(frame)
        assert served.lane_info.lanes_status == native.lane_info.lanes_status
        assert [list(p) for p in served.lane_info.lanes_points] == \
            [list(p) for p in native.lane_info.lanes_points]


def test_multistream_mode(npz_paths, reduced_culane, tmp_path, capsys):
    out = str(tmp_path / "pipe.adas")
    build_engine.main(["-t", "YOLOV8", "--scale", "n", "--height", "160", "--width", "160",
                       "-w", npz_paths["yolo"], "--lane-weights", npz_paths["lane"],
                       "-o", out, "--platforms", "cpu", "--multistream", "2",
                       "--frame-height", "180", "--frame-width", "320",
                       "--downscale", "88", "160"])
    printed = capsys.readouterr().out
    assert "multistream pipeline engine" in printed and "(2 streams, i420)" in printed
    meta = read_meta(out)
    assert meta["kind"] == "multistream" and tuple(meta["frame_shape"]) == (2, 132, 160)
    yolo, lane = _port_pair(npz_paths)
    yolo.box_score = 0.4  # the CLI's facade keeps JAX's default
    kw = dict(frame_hw=FRAME_HW, host_downscale=(88, 160), transport="i420")
    native = MultiStreamADAS(yolo, lane, 2, **kw)
    served = MultiStreamADAS(yolo, lane, 2, step_artifact=out, **kw)
    frames = _ticks(1, seed=4)[0]
    assert torch.equal(native.submit(frames), served.submit(frames))
    native.close()
    served.close()
