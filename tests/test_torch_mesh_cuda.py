"""The port's mesh paths on the card: ``MultiStreamADAS`` over a mesh that
repeats ``cuda:0`` against the unsharded pipeline, and the int8 UFLD head
split over ``model`` against the unsharded head.

Needs an NVIDIA GPU with nvcc (the kernels are built for sm_90a); each
test skips where there is none.  This file imports no JAX, so it runs on
the GPU machine without the repository's conftest:

    python -m pytest tests/test_torch_mesh_cuda.py -q --noconftest -p no:cacheprovider

YOLOv8n at 320x320 and UFLDv2-TuSimple from seeds, calibrated int8 on two
frames, 4 streams of 360x640: each data row (two, both on ``cuda:0``)
runs every kernel of the unsharded step on its two streams, and each
row's packed output equals the unsharded pipeline's step on the same two
streams to the bit, on I420 and on bgr; the launches of a mesh tick are
twice a row's.  Against the unsharded 4-stream tick the int8 nets are
batch-invariant, but the I420 preprocess's f32 resize matmuls
(``ops/preprocess.py:221-222``) are not: cuBLAS picks its GEMM by the
batch, and a few bf16 inputs come out one ulp apart (``chip_smoke.py``
``[mesh-int8]`` holds the 8-stream tick to the int8 slice's
matched-detections yardstick for that).  The int8 head split in two
over ``model`` sums its s32 partials before the dequant and equals the
unsharded net's outputs to the bit.
"""
import numpy as np
import pytest
import torch

from adas_tpu_torch.ops import block, int8_conv, iou, nms, stem
from adas_tpu_torch.parallel import Mesh, make_sharded_stream_step
from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

pytestmark = pytest.mark.cuda

KERNELS = {"stem": stem, "int8_conv": int8_conv, "block": block, "iou": iou, "nms": nms}
FRAME_HW = (360, 640)


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU build)")
    yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", input_size=(320, 320),
                        box_score=0.25, compute_dtype="int8", device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_TUSIMPLE,
                                   compute_dtype="int8", device="cuda", seed=1)
    calib = np.random.default_rng(0).integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    yolo.calibrate_int8(list(calib))
    lane.calibrate_int8(list(calib))
    return yolo, lane


def launches():
    return {k: m.launches for k, m in KERNELS.items()}


def reset():
    for m in KERNELS.values():
        m.reset_launches()


@pytest.mark.parametrize("transport", ["i420", "bgr"])
def test_repeated_device_mesh_rows_equal_unsharded(pair, transport):
    frames = np.random.default_rng(1).integers(0, 256, (4, *FRAME_HW, 3), dtype=np.uint8)
    plain = MultiStreamADAS(*pair, 4, FRAME_HW, transport=transport)
    mesh = Mesh([["cuda:0"], ["cuda:0"]])
    ms = MultiStreamADAS(*pair, 4, FRAME_HW, mesh=mesh, transport=transport)
    x0 = plain._prep_upload(frames)
    want = torch.cat([plain._step(x0[:2]), plain._step(x0[2:])])
    ms.submit(frames)  # the replicas' plans and maps
    torch.cuda.synchronize()
    reset()
    x = ms._prep_upload(frames)
    ms._row_step(0, x[0])
    torch.cuda.synchronize()
    per_row = launches()
    reset()
    got = ms.submit(frames)
    torch.cuda.synchronize()
    assert launches() == {k: 2 * v for k, v in per_row.items()}
    assert per_row["stem"] == 2 and per_row["int8_conv"] > 0 and per_row["iou"] == 1
    assert all(g.device == torch.device("cuda", 0) for g in got)
    got = torch.cat(got)
    for i in range(4):
        assert torch.equal(got[i], want[i]), i
    results = ms.fetch(ms.submit(frames), frames)
    assert len(results) == 4 and all(len(r["objects"]) > 0 for r in results)
    ms.close()
    plain.close()


def test_int8_head_split_equals_unsharded(pair):
    net = pair[1].net
    x = torch.randn(4, 3, 320, 800, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        want = net(x)
    step = make_sharded_stream_step(lambda n, f: n(f), net, Mesh([["cuda:0", "cuda:0"]]))
    assert step.replicas.tp
    got = step(x)
    assert len(got) == 1
    for k, v in want.items():
        assert torch.equal(got[0][k], v), k
